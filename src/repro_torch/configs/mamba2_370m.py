"""mamba2-370m [ssm]: 48L d_model=1024, attn-free, vocab 50280, state 128.

SSD (state-space duality), arXiv:2405.21060.  d_inner = 2*d_model = 2048,
headdim 64 -> 32 SSD heads, 1 B/C group, conv width 4.
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        vocab=50304,  # 50280 padded to %128==0 for vocab TP (Megatron practice)
        d_ff=0,
        n_heads=0,
        n_kv_heads=1,
        head_dim=0,
        ssm_state=128,
        ssm_headdim=64,
        ssm_ngroups=1,
        ssm_expand=2,
        ssm_conv=4,
        ssm_chunk=128,
        norm="rmsnorm",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().scaled(vocab=512, n_layers=2)
