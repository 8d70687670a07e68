"""stablelm-3b [dense]: 32L d=2560 32H MHA, d_ff 6912, vocab 50304.

stablelm family uses LayerNorm (not RMSNorm) and SiLU MLP.
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        vocab=50304,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=6912,
        mlp_act="swiglu",
        norm="layernorm",
    )


def smoke() -> ModelConfig:
    return config().scaled()
