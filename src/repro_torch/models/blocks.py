"""Decoder block assembly (port of ``repro.models.blocks``, dense kinds).

Kind "attn" (attention + dense MLP) is ported.  The MoE feed-forward and
the "mamba2" and "rglru" mixers are not yet (ROADMAP Queue 1 item 13), nor
is one-token decode.  The block window is the sliding window for SWA
archs and the local window for hybrid attn layers; None means full
attention.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import attention_forward, attention_meta
from .config import ModelConfig
from .layers import apply_norm, rmsnorm_meta
from .mlp import mlp_forward, mlp_meta

__all__ = ["block_meta", "block_forward", "block_window", "ZERO_AUX"]

ZERO_AUX = {"moe_lb": 0.0, "moe_z": 0.0}


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP Queue 1 item 13 (the other model families)"
    )


def block_window(cfg: ModelConfig, kind: str) -> Optional[int]:
    if cfg.family == "hybrid" and kind == "attn":
        return cfg.local_window
    return cfg.sliding_window


def block_meta(cfg: ModelConfig, kind: str, model_axis: int = 16) -> dict:
    if kind != "attn":
        raise _not_ported(f"the {kind!r} block")
    if cfg.n_experts > 0:
        raise _not_ported("the MoE feed-forward")
    pd = cfg.parameter_dtype
    return {
        "norm1": rmsnorm_meta(cfg.d_model, cfg.norm, pd),
        "attn": attention_meta(cfg, pd),
        "norm2": rmsnorm_meta(cfg.d_model, cfg.norm, pd),
        "mlp": mlp_meta(cfg, pd),
    }


def block_forward(
    p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor
) -> Tuple[torch.Tensor, dict]:
    if kind != "attn" or cfg.n_experts > 0:
        raise _not_ported(f"the {kind!r} block" if kind != "attn" else "the MoE feed-forward")
    h = apply_norm(p["norm1"], x, cfg.norm)
    x = x + attention_forward(p["attn"], cfg, h, window=block_window(cfg, kind))
    h2 = apply_norm(p["norm2"], x, cfg.norm)
    x = x + mlp_forward(p["mlp"], cfg, h2)
    return x, dict(ZERO_AUX)
