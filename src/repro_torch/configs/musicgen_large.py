"""musicgen-large [audio]: 48L d=2048 32H MHA, d_ff 8192 (plain GELU),
vocab 2048 (EnCodec codes).  arXiv:2306.05284.

Backbone only: the EnCodec frontend is a STUB — prefill consumes
precomputed frame embeddings (frontend_dim 512); decode generates codes.
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        vocab=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        mlp_act="gelu",
        norm="layernorm",
        frontend="audio",
        frontend_dim=512,
    )


def smoke() -> ModelConfig:
    return config().scaled()
