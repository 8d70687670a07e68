"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8), 40 experts top-8,
d_ff 512 per expert, vocab 49155."""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        vocab=49280,  # 49155 padded to %128==0 for vocab TP (Megatron practice)
        n_heads=24,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,
        n_experts=40,
        top_k=8,
        moe_impl="dropping",
        mlp_act="swiglu",
        norm="rmsnorm",
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return config().scaled(n_experts=4, top_k=2, moe_impl="dense")
