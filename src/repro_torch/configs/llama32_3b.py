"""llama3.2-3b [dense]: 28L d=3072 24H (GQA kv=8), d_ff 8192, vocab 128256."""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        vocab=128_256,
        n_heads=24,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        rope_theta=500_000.0,
        mlp_act="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().scaled()
