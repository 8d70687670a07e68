"""Attention: GQA/MQA/MHA with rotary and qk-norm, for training and
prefill (port of ``repro.models.attention``, ``attn_shard_mode="none"``).

The full sequence goes through chunked flash attention
(``repro_torch.models.flash``) in the grouped-GQA layout: queries
(B, nq, cq, Hkv, G, hd) against keys and values (B, S, Hkv, hd), never
materializing S x S logits.  The other shard modes split heads or query
chunks over a device mesh and are not ported yet, nor is one-token decode
against a cache (the serve path).
"""
from __future__ import annotations

from typing import Optional

import torch

from .config import ModelConfig
from .flash import flash_attention
from .layers import apply_norm, apply_rotary, rmsnorm_meta, rotary_cos_sin
from .params import ParamMeta

__all__ = ["attention_meta", "attention_forward"]


def attention_meta(cfg: ModelConfig, pdtype, *, window: Optional[int] = None) -> dict:
    d = cfg.d_model
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    meta = {
        "wq": ParamMeta((d, hq, hd), pdtype, ("embed", "q_heads", "head_dim")),
        "wk": ParamMeta((d, hkv, hd), pdtype, ("embed", "kv_heads", "head_dim")),
        "wv": ParamMeta((d, hkv, hd), pdtype, ("embed", "kv_heads", "head_dim")),
        "wo": ParamMeta((hq, hd, d), pdtype, ("q_heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        meta["bq"] = ParamMeta((hq, hd), pdtype, ("q_heads", "head_dim"), init="zeros")
        meta["bk"] = ParamMeta((hkv, hd), pdtype, ("kv_heads", "head_dim"), init="zeros")
        meta["bv"] = ParamMeta((hkv, hd), pdtype, ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        meta["q_norm"] = rmsnorm_meta(hd, "rmsnorm", pdtype)
        meta["k_norm"] = rmsnorm_meta(hd, "rmsnorm", pdtype)
    return meta


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, "rmsnorm")
        k = apply_norm(p["k_norm"], k, "rmsnorm")
    return q, k, v


def attention_forward(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal self-attention over a full sequence (train / prefill).

    x: (B, S, D).  ``window``: sliding/local attention width (None = full).
    """
    if cfg.attn_shard_mode != "none":
        raise NotImplementedError(
            f"attn_shard_mode={cfg.attn_shard_mode!r} splits attention over a device mesh, "
            "which is not ported yet: ROADMAP Queue 1 item 12 (multi-device)"
        )
    B, S, D = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(p, cfg, x)

    cos, sin = rotary_cos_sin(torch.arange(S, device=x.device), hd, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    q = q * (hd ** -0.5)

    cq = min(cfg.attn_chunk, S)
    assert S % cq == 0, (S, cq)
    nq = S // cq
    ck = min(cfg.attn_kv_chunk, S)
    q6 = q.reshape(B, nq, cq, hkv, hq // hkv, hd)
    o6 = flash_attention(q6, k, v, ck, window, cfg.attn_logit_softcap)
    attn = o6.reshape(B, S, hq, hd)
    return torch.einsum("bshk,hkd->bsd", attn, p["wo"].to(x.dtype))
