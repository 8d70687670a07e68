"""mixtral-8x7b [moe]: 32L d=4096 32H (GQA kv=8), 8 experts top-2,
d_ff 14336, SWA 4096, vocab 32000.  arXiv:2401.04088."""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        vocab=32000,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        n_experts=8,
        top_k=2,
        moe_impl="dropping",
        sliding_window=4096,
        mlp_act="swiglu",
        norm="rmsnorm",
    )


def smoke() -> ModelConfig:
    return config().scaled(n_experts=4, top_k=2, moe_impl="dense")
