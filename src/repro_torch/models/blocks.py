"""Decoder block assembly: meta / forward / cache / decode per kind (port of
``repro.models.blocks``).

Kinds: "attn" (attention + dense MLP or MoE feed-forward), "mamba2" (SSD
only; d_ff == 0), "rglru" (RG-LRU mixer + MLP), each for the full sequence
and for one-token decode against a cache.  The block window is the sliding
window for SWA archs (mixtral) and the local window for hybrid
(recurrentgemma) attn layers; None means full attention.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.parallel import hints

from .attention import attention_decode, attention_forward, attention_meta, attn_cache_meta
from .config import ModelConfig
from .griffin import rglru_cache_meta, rglru_decode, rglru_forward, rglru_meta
from .layers import apply_norm, rmsnorm_meta
from .mamba2 import mamba2_cache_meta, mamba2_decode, mamba2_forward, mamba2_meta
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


def block_window(cfg: ModelConfig, kind: str) -> Optional[int]:
    if cfg.family == "hybrid" and kind == "attn":
        return cfg.local_window
    return cfg.sliding_window


def block_meta(cfg: ModelConfig, kind: str, model_axis: int = 16) -> dict:
    pd = cfg.parameter_dtype
    meta = {"norm1": rmsnorm_meta(cfg.d_model, cfg.norm, pd)}
    if kind == "attn":
        meta["attn"] = attention_meta(cfg, pd)
        meta["norm2"] = rmsnorm_meta(cfg.d_model, cfg.norm, pd)
        if cfg.n_experts > 0:
            meta["moe"] = moe_meta(cfg, pd, model_axis)
        else:
            meta["mlp"] = mlp_meta(cfg, pd)
    elif kind == "mamba2":
        meta["mamba"] = mamba2_meta(cfg, pd)
    elif kind == "rglru":
        meta["rglru"] = rglru_meta(cfg, pd)
        meta["norm2"] = rmsnorm_meta(cfg.d_model, cfg.norm, pd)
        meta["mlp"] = mlp_meta(cfg, pd)
    else:
        raise ValueError(kind)
    return meta


def _ffn(p: dict, cfg: ModelConfig, h: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    if cfg.n_experts > 0:
        y, aux = moe_forward(p["moe"], cfg, h)
        return y, {**ZERO_AUX, **aux}
    return mlp_forward(p["mlp"], cfg, h), dict(ZERO_AUX)


def _norm(p: dict, key: str, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # Under sequence parallelism each rank normalizes its own rows: the
    # scale's gradient is summed over the ranks that split the sequence.
    return apply_norm(hints.shared_param(p[key], "act_res_seq"), x, cfg.norm)


def block_forward(
    p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor
) -> Tuple[torch.Tensor, dict]:
    """x (B, S, D) in the residual stream's layout (the sequence split on
    the model axis under sequence parallelism) -> the same, and aux losses."""
    h = _norm(p, "norm1", cfg, x)
    if kind == "attn":
        x = x + attention_forward(p["attn"], cfg, h, window=block_window(cfg, kind))
        y, aux = _ffn(p, cfg, _norm(p, "norm2", cfg, x))
        return x + y, aux
    if kind == "mamba2":
        return x + mamba2_forward(p["mamba"], cfg, h), dict(ZERO_AUX)
    if kind == "rglru":
        x = x + rglru_forward(p["rglru"], cfg, h)
        return x + mlp_forward(p["mlp"], cfg, _norm(p, "norm2", cfg, x)), dict(ZERO_AUX)
    raise ValueError(kind)


def block_cache_meta(cfg: ModelConfig, kind: str, batch: int, max_len: int) -> dict:
    if kind == "attn":
        return attn_cache_meta(cfg, batch, max_len, block_window(cfg, kind))
    if kind == "mamba2":
        return mamba2_cache_meta(cfg, batch)
    if kind == "rglru":
        return rglru_cache_meta(cfg, batch)
    raise ValueError(kind)


def block_decode(
    p: dict, cfg: ModelConfig, kind: str, x: torch.Tensor, cache: dict, pos: torch.Tensor
) -> Tuple[torch.Tensor, dict]:
    """One token: x (B, 1, D) against the block's cache, which is updated
    in place and returned."""
    h = apply_norm(p["norm1"], x, cfg.norm)
    if kind == "attn":
        y, cache = attention_decode(p["attn"], cfg, h, cache, pos, window=block_window(cfg, kind))
        x = x + y
        y2, _ = _ffn(p, cfg, apply_norm(p["norm2"], x, cfg.norm))
        return x + y2, cache
    if kind == "mamba2":
        y, cache = mamba2_decode(p["mamba"], cfg, h, cache, pos)
        return x + y, cache
    if kind == "rglru":
        y, cache = rglru_decode(p["rglru"], cfg, h, cache, pos)
        x = x + y
        return x + mlp_forward(p["mlp"], cfg, apply_norm(p["norm2"], x, cfg.norm)), cache
    raise ValueError(kind)
