"""Attention: GQA/MQA/MHA with rotary, qk-norm and sliding windows (port
of ``repro.models.attention``, ``attn_shard_mode="none"``).

Training and prefill send the full sequence through chunked flash
attention (``repro_torch.models.flash``) in the grouped-GQA layout:
queries (B, nq, cq, Hkv, G, hd) against keys and values (B, S, Hkv, hd),
never materializing S x S logits.  The other shard modes split heads or
query chunks over a device mesh and are not ported yet.

Decode attends one query against a cache.  Full-attention layers keep a
``max_len`` cache; sliding-window layers (mixtral) keep a ring buffer of
``min(window, max_len)`` slots, the new key written at slot ``pos % W``.
The cache is updated in place by a tensor-indexed write at the device-side
position ``pos``, so a step has no host sync.  A write past ``max_len``
raises (``index_copy_``'s bound check; on the card as a device-side
assert) where the JAX package's ``dynamic_update_slice`` clamps it onto
the last slot without a word.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.backend import probe

from .config import ModelConfig
from .flash import flash_attention
from .layers import apply_norm, apply_rotary, rmsnorm_meta, rotary_cos_sin
from .params import ParamMeta

__all__ = [
    "attention_meta",
    "attention_forward",
    "attn_cache_meta",
    "attn_cache_init",
    "attention_decode",
]

NEG_INF = -1e30


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
            "which is not ported yet: ROADMAP Queue 1 item 12(b) (model sharding)"
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


# ----------------------------------------------------------------------
# Decode (single new token against a cache)
# ----------------------------------------------------------------------

def attn_cache_meta(cfg: ModelConfig, batch: int, max_len: int, window: Optional[int]) -> dict:
    """Cache shapes of one attention layer, as ``meta``-device tensors."""
    W = min(window, max_len) if window else max_len
    shape = (batch, W, cfg.n_kv_heads, cfg.head_dim)
    dt = cfg.activation_dtype
    return {"k": torch.empty(shape, dtype=dt, device="meta"),
            "v": torch.empty(shape, dtype=dt, device="meta")}


def attn_cache_init(cfg: ModelConfig, batch: int, max_len: int, window: Optional[int],
                    *, device: Optional[Union[str, torch.device]] = None) -> dict:
    """Zero caches on ``device`` (default ``"cuda"``, which raises without a
    card: pass ``device="cpu"``)."""
    dev = probe.resolve_device(device)
    meta = attn_cache_meta(cfg, batch, max_len, window)
    return {k: torch.zeros(m.shape, dtype=m.dtype, device=dev) for k, m in meta.items()}


def attention_decode(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    cache: dict,
    pos: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  x: (B, 1, D); pos: 0-d int tensor (the current
    index), on x's device.

    Writes the new key and value into ``cache`` in place and returns
    (out (B, 1, D), cache).  Windowed layers use a ring buffer (slot =
    pos % W); full layers write slot = pos.
    """
    B = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ck, cv = cache["k"], cache["v"]
    W = ck.shape[1]

    q, k, v = _project_qkv(p, cfg, x)
    cos, sin = rotary_cos_sin(pos[None], hd, cfg.rope_theta)
    q = apply_rotary(q, cos[None], sin[None])
    k = apply_rotary(k, cos[None], sin[None])

    slot = (pos % W if window is not None else pos).reshape(1).long()
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))

    # Positions held in each slot, for the mask (keys were rotated with
    # their absolute positions when written).
    slots = torch.arange(W, device=x.device)
    if window is not None:
        # Ring buffer: slot s holds the latest position p <= pos with
        # p % W == s (torch's % on tensors is the floor-mod JAX uses).
        valid = (pos - ((pos - slots) % W)) >= 0
    else:
        valid = slots <= pos

    qg = (q * hd ** -0.5).reshape(B, 1, hkv, hq // hkv, hd)
    # float32 scores from the cache's dtype (JAX: preferred_element_type).
    s = torch.einsum("bqhgk,bchk->bhgqc", qg.to(torch.float32), ck.to(torch.float32))
    if cfg.attn_logit_softcap is not None:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    s = torch.where(valid, s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqc,bchk->bhgqk", pr.to(cv.dtype), cv)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, 1, hq, hd)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return out, cache
