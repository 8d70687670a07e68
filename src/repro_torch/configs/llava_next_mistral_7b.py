"""llava-next-mistral-7b [vlm]: mistral-7b backbone — 32L d=4096 32H
(GQA kv=8), d_ff 14336, vocab 32000.

Backbone only: the anyres vision tower is a STUB — prefill consumes
precomputed patch embeddings (frontend_dim 1024, CLIP-large width).
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        n_layers=32,
        d_model=4096,
        vocab=32000,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        mlp_act="swiglu",
        norm="rmsnorm",
        frontend="vision",
        frontend_dim=1024,
    )


def smoke() -> ModelConfig:
    return config().scaled()
