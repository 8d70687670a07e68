"""Attention: GQA/MQA/MHA with rotary, qk-norm and sliding windows (port
of ``repro.models.attention``).

Training and prefill send the full sequence through chunked flash
attention (``repro_torch.models.flash``) in the grouped-GQA layout:
queries (B, nq, cq, Hkv, G, hd) against keys and values (B, S, Hkv, hd),
never materializing S x S logits.  Under a sharding resolver
(``repro_torch.parallel.hints``) the shard modes of ``cfg.attn_shard_mode``
split the work over the model axis, each rank holding its block of the
weights:

* ``heads`` (and ``none``): ``wq`` / ``wk`` / ``wv`` column-split, each rank
  with ``n_kv_heads / m`` KV heads and their query groups; ``wo`` row-split,
  its partial sums reduced.
* ``q_heads``: K/V repeated to the query heads first (JAX's layout), ``wk``
  / ``wv`` replicated; each rank takes ``n_heads / m`` heads.
* ``cp``: the weights replicated; each rank computes the query chunks it
  owns against all of K/V, and the output chunks are gathered along the
  sequence.

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
from repro_torch.parallel import comm, hints

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


RES = ("act_batch", "act_res_seq", None)  # the residual stream's layout


def _attn_split(cfg: ModelConfig, res) -> Tuple[str, Optional[str]]:
    """(mode, the logical name of the axes that split the work)."""
    mode = cfg.attn_shard_mode
    if mode == "cp":
        return mode, "act_q_chunks"
    if mode not in ("none", "heads", "q_heads"):
        raise ValueError(f"attn_shard_mode={mode!r}: one of none, heads, q_heads, cp")
    if res is not None and res.axes("act_q_chunks"):
        raise ValueError(f"the policy splits query chunks (cp) but attn_shard_mode={mode!r}")
    if res is not None and mode != "q_heads" and res.axes("act_heads") != res.axes("act_kv_heads"):
        raise ValueError(f"the policy splits q heads over {res.axes('act_heads')} and KV heads over "
                         f"{res.axes('act_kv_heads')}: that is attn_shard_mode='q_heads', not {mode!r}")
    return mode, "act_heads"


def attention_forward(
    p: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal self-attention over a full sequence (train / prefill).

    x: (B, S, D) in the residual stream's layout (sequence split on the
    model axis under sequence parallelism).  ``window``: sliding/local
    attention width (None = full).  Each rank holds its block of ``p``.
    """
    res = hints.active_resolver()
    mode, work = _attn_split(cfg, res)
    x = hints.tp_input(x, RES, work)
    if mode == "cp":
        p = hints.shared_param(p, work)
    elif mode == "q_heads":
        p = {k: (hints.shared_param(v, work) if k in ("wk", "wv", "bk", "bv", "k_norm") else v)
             for k, v in p.items()}
    B, S, D = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(p, cfg, x)
    hq_loc = q.shape[2]  # this rank's query heads

    cos, sin = rotary_cos_sin(torch.arange(S, device=x.device), hd, cfg.rope_theta)
    q = apply_rotary(q, cos, sin)
    k = apply_rotary(k, cos, sin)
    q = q * (hd ** -0.5)

    if mode == "q_heads":
        k = torch.repeat_interleave(k, hq // hkv, dim=2)
        v = torch.repeat_interleave(v, hq // hkv, dim=2)
        if hq_loc != hq:  # this rank's heads of the repeated K/V
            h0 = hints.active_resolver().index(work) * hq_loc
            k, v = k[:, :, h0:h0 + hq_loc], v[:, :, h0:h0 + hq_loc]
        hkv_eff, G = hq_loc, 1
        kv_hint, head_hint = ("act_batch", None, "act_heads", None), "act_heads"
    elif mode == "cp":
        hkv_eff, G = hkv, hq // hkv
        kv_hint, head_hint = ("act_batch", None, None, None), None
    else:
        hkv_eff, G = k.shape[2], hq // hkv
        kv_hint, head_hint = ("act_batch", None, "act_kv_heads", None), "act_kv_heads"
    k = hints.shard_hint(k, kv_hint)
    v = hints.shard_hint(v, kv_hint)

    cq = min(cfg.attn_chunk, S)
    assert S % cq == 0, (S, cq)
    nq = S // cq
    ck = min(cfg.attn_kv_chunk, S)
    q6 = q.reshape(B, nq, cq, hkv_eff, G, hd)
    c0 = 0
    if mode == "cp" and res is not None and res.axes(work):
        c0, c1 = comm.chunk_bounds(nq, res.size(work), res.index(work))
        q6 = q6[:, c0:c1]  # the query chunks this rank owns
    q6 = hints.shard_hint(q6, ("act_batch", "act_q_chunks" if mode == "cp" else None, None, head_hint, None, None))
    o6 = flash_attention(q6, k, v, ck, window, cfg.attn_logit_softcap, c0 * cq)
    attn = o6.reshape(B, -1, hq_loc, hd)
    out = torch.einsum("bshk,hkd->bsd", attn, p["wo"].to(x.dtype))
    if mode != "cp":
        return hints.shard_hint(out, RES, partial=work)
    if res is not None and res.axes(work):
        out = comm.all_gather(out.reshape(B, -1, cq, D), res.mesh, res.axes(work), 1, length=nq, grad="slice")
        out = out.reshape(B, S, D)
    return hints.shard_hint(out, RES, src=("act_batch", None, None))


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

    Under a decode resolver (``MeshResolver.for_decode``) each rank holds
    its block of ``p`` and of the cache: in ``heads`` mode its KV heads
    (and their query heads); where the policy leaves KV heads whole
    (``q_heads``, ``cp``) the cache's window is split instead
    (``act_cache_window``): each rank scores every query head against its
    slice of the slots, the softmax max and sum are reduced over the ranks,
    and only the rank that holds the slot writes the new key.
    """
    B = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ck, cv = cache["k"], cache["v"]
    res = hints.active_resolver()
    mode, work = _attn_split(cfg, res)
    win = res.axes("act_cache_window") if res is not None else ()

    q, k, v = _project_qkv(p, cfg, x)
    cos, sin = rotary_cos_sin(pos[None], hd, cfg.rope_theta)
    q = apply_rotary(q, cos[None], sin[None])
    k = apply_rotary(k, cos[None], sin[None])

    Wl = ck.shape[1]
    W = Wl * res.size(win) if win else Wl
    w0 = res.index(win) * Wl if win else 0
    slot = (pos % W if window is not None else pos).reshape(1).long()
    if win:  # only the rank that holds the slot writes it
        local = slot - w0
        mine = (local >= 0) & (local < Wl)
        slot = local.clamp(0, Wl - 1)
        k = torch.where(mine, k.to(ck.dtype), ck.index_select(1, slot))
        v = torch.where(mine, v.to(cv.dtype), cv.index_select(1, slot))
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))

    # Positions held in each slot, for the mask (keys were rotated with
    # their absolute positions when written).
    slots = torch.arange(w0, w0 + Wl, device=x.device)
    if window is not None:
        # Ring buffer: slot s holds the latest position p <= pos with
        # p % W == s (torch's % on tensors is the floor-mod JAX uses).
        valid = (pos - ((pos - slots) % W)) >= 0
    else:
        valid = slots <= pos

    hq_loc = q.shape[2]
    if win and hq_loc != hq:  # every query head scores this rank's slots
        q = comm.all_gather(q, res.mesh, res.axes(work), 2)
    hkv_loc = ck.shape[2]
    qg = (q * hd ** -0.5).reshape(B, 1, hkv_loc, -1, hd)
    # float32 scores from the cache's dtype (JAX: preferred_element_type).
    s = torch.einsum("bqhgk,bchk->bhgqc", qg.to(torch.float32), ck.to(torch.float32))
    if cfg.attn_logit_softcap is not None:
        s = cfg.attn_logit_softcap * torch.tanh(s / cfg.attn_logit_softcap)
    s = torch.where(valid, s, NEG_INF)
    if not win:
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqc,bchk->bhgqk", pr.to(cv.dtype), cv)
        o = o.permute(0, 3, 1, 2, 4).reshape(B, 1, hq_loc, hd)
    else:  # the softmax over every rank's slots
        m = s.amax(-1, keepdim=True)
        pr = torch.exp(s - m)
        o = torch.einsum("bhgqc,bchk->bhgqk", pr.to(cv.dtype), cv).to(torch.float32)
        M = comm.all_reduce_max(m, res.mesh, win)
        scale = torch.exp(m - M)
        l = comm.all_reduce(pr.sum(-1, keepdim=True) * scale, res.mesh, win)
        o = (o * scale).permute(0, 3, 1, 2, 4).reshape(B, 1, hq, hd)
        l = l.permute(0, 3, 1, 2, 4).reshape(B, 1, hq, 1)
        if hq_loc != hq:  # this rank's query heads of the sum, for its rows of wo
            o = comm.reduce_scatter(o, res.mesh, win, 2)
            l = comm.split(l, res.mesh, win, 2)
        else:
            o = comm.all_reduce(o, res.mesh, win)
        o = (o / l).to(cv.dtype)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return hints.shard_hint(out, RES, partial=None if mode == "cp" else work), cache
