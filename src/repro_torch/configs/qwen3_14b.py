"""qwen3-14b [dense]: 40L d=5120 40H (GQA kv=8), qk-norm, d_ff 17408."""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        vocab=151_936,
        n_heads=40,
        n_kv_heads=8,
        head_dim=128,
        d_ff=17408,
        qk_norm=True,
        rope_theta=1_000_000.0,
        mlp_act="swiglu",
        norm="rmsnorm",
    )


def smoke() -> ModelConfig:
    return config().scaled(qk_norm=True)
