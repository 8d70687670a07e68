"""Decoder block assembly: meta / forward / cache / decode per kind (port of
``repro.models.blocks``).

Kind "attn" (attention + dense MLP or MoE feed-forward) is ported, for the
full sequence and for one-token decode against a cache.  The "mamba2" and
"rglru" mixers are not yet (ROADMAP Queue 1 item 13(b)).  The block window
is the sliding window for SWA archs (mixtral) and the local window for
hybrid attn layers; None means full attention.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .attention import attention_decode, attention_forward, attention_meta, attn_cache_meta
from .config import ModelConfig
from .layers import apply_norm, rmsnorm_meta
from .mlp import mlp_forward, mlp_meta
from .moe import moe_forward, moe_meta

__all__ = [
    "block_meta",
    "block_forward",
    "block_decode",
    "block_cache_meta",
    "block_window",
    "ZERO_AUX",
]

ZERO_AUX = {"moe_lb": 0.0, "moe_z": 0.0}


def _kind_error(kind: str):
    block = {"mamba2": "the Mamba2 block", "rglru": "the RG-LRU block"}.get(kind)
    if block is None:
        return ValueError(kind)
    return NotImplementedError(f"{block} is not ported yet: ROADMAP Queue 1 item 13(b)")


def block_window(cfg: ModelConfig, kind: str) -> Optional[int]:
    if cfg.family == "hybrid" and kind == "attn":
        return cfg.local_window
    return cfg.sliding_window


def block_meta(cfg: ModelConfig, kind: str, model_axis: int = 16) -> dict:
    if kind != "attn":
        raise _kind_error(kind)
    pd = cfg.parameter_dtype
    meta = {
        "norm1": rmsnorm_meta(cfg.d_model, cfg.norm, pd),
        "attn": attention_meta(cfg, pd),
        "norm2": rmsnorm_meta(cfg.d_model, cfg.norm, pd),
    }
    if cfg.n_experts > 0:
        meta["moe"] = moe_meta(cfg, pd, model_axis)
    else:
        meta["mlp"] = mlp_meta(cfg, pd)
    return meta


def _ffn(p: dict, cfg: ModelConfig, h: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    if cfg.n_experts > 0:
        y, aux = moe_forward(p["moe"], cfg, h)
        return y, {**ZERO_AUX, **aux}
    return mlp_forward(p["mlp"], cfg, h), dict(ZERO_AUX)


def block_forward(
    p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor
) -> Tuple[torch.Tensor, dict]:
    if kind != "attn":
        raise _kind_error(kind)
    h = apply_norm(p["norm1"], x, cfg.norm)
    x = x + attention_forward(p["attn"], cfg, h, window=block_window(cfg, kind))
    y, aux = _ffn(p, cfg, apply_norm(p["norm2"], x, cfg.norm))
    return x + y, aux


def block_cache_meta(cfg: ModelConfig, kind: str, batch: int, max_len: int) -> dict:
    if kind != "attn":
        raise _kind_error(kind)
    return attn_cache_meta(cfg, batch, max_len, block_window(cfg, kind))


def block_decode(
    p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, cache: dict, pos: torch.Tensor
) -> Tuple[torch.Tensor, dict]:
    """One token: x (B, 1, D) against the block's cache, which is updated
    in place and returned."""
    if kind != "attn":
        raise _kind_error(kind)
    h = apply_norm(p["norm1"], x, cfg.norm)
    y, cache = attention_decode(p["attn"], cfg, h, cache, pos, window=block_window(cfg, kind))
    x = x + y
    y2, _ = _ffn(p, cfg, apply_norm(p["norm2"], x, cfg.norm))
    return x + y2, cache
