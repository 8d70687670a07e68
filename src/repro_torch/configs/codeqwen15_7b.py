"""codeqwen1.5-7b [dense]: 32L d=4096 32H MHA, d_ff 13440, vocab 92416.

hf:Qwen/CodeQwen1.5-7B — qwen1.5 architecture (QKV bias, full MHA).
"""
from repro_torch.models import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        vocab=92416,
        n_heads=32,
        n_kv_heads=32,
        head_dim=128,
        d_ff=13440,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        mlp_act="swiglu",
        norm="rmsnorm",
    )


def smoke() -> ModelConfig:
    return config().scaled()
