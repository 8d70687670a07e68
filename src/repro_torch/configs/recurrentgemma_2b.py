"""recurrentgemma-2b [hybrid]: 26L d=2560, RG-LRU + local attention (1:2).

arXiv:2402.19427 (Griffin).  Pattern (rglru, rglru, attn); MQA kv=1,
head_dim 256; GeGLU d_ff 7680; local window 2048; vocab 256000.
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        vocab=256_000,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        mlp_act="geglu",
        griffin_pattern=("rglru", "rglru", "attn"),
        local_window=2048,
        lru_width=2560,
        ssm_conv=4,
        norm="rmsnorm",
        tie_embeddings=True,
        logit_softcap=30.0,
    )


def smoke() -> ModelConfig:
    return config().scaled(n_layers=3, n_heads=2, head_dim=16, vocab=512)
