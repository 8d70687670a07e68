"""Griffin recurrent block (RG-LRU), recurrentgemma's temporal mixer (port
of ``repro.models.griffin``; plain torch, as the JAX module is plain jnp).

    r_t = sigmoid(BlockDiag_a(x_t))          # recurrence gate
    i_t = sigmoid(BlockDiag_x(x_t))          # input gate
    a_t = exp(-c * softplus(Lambda) * r_t)   # c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The linear recurrence runs as a log-depth inclusive scan within chunks of
at most 512 positions and a sequential carry across them, each chunk under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` on its
chunk body), so the backward keeps only the (B, W) carries.  The scan is
Hillis-Steele doubling over (a, b) pairs, never ``cumprod(a)`` and a
division: under the ``lru_a`` init a single step's a reaches e^-55, so the
products underflow within a chunk.  Gates are block-diagonal (n_heads
blocks), in float32.

Block structure: x -> (gate branch: linear + GeLU) * (x branch: linear ->
causal conv(4) -> RG-LRU) -> output linear.  Decode carries (h, conv
window), O(width) state, updated in place.

Under a sharding resolver whose ``act_mlp`` is a mesh axis (tensor
parallelism), each rank holds its block of the width: columns of ``w_x``,
``w_gate``, ``conv_*``, ``bias_*`` and ``lam``, rows of ``w_out`` (whose
partial sums are reduced, or reduce-scattered under sequence
parallelism).  The block-diagonal gates ``gate_a`` / ``gate_x`` are
replicated (their gradients summed over the model axis): a rank applies
the blocks of the heads its columns meet.  A cut inside a head (10 heads
of 256 on 4 or 16 ranks) needs the head's other columns, so the gates'
input is then all-gathered over the model axis first.  Decode splits
``h`` and the conv window on the width the same way.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel import comm, hints

from .config import ModelConfig
from .params import ParamMeta

__all__ = ["rglru_meta", "rglru_forward", "rglru_decode", "rglru_cache_meta"]

_C = 8.0
_CHUNK = 512
RES = ("act_batch", "act_res_seq", None)  # the residual stream's layout


def _width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def rglru_meta(cfg: ModelConfig, pdtype) -> dict:
    d = cfg.d_model
    w = _width(cfg)
    h = cfg.n_heads
    bw = w // h
    return {
        "w_x": ParamMeta((d, w), pdtype, ("embed", "mlp")),
        "w_gate": ParamMeta((d, w), pdtype, ("embed", "mlp")),
        "conv_w": ParamMeta((cfg.ssm_conv, w), pdtype, ("conv", "mlp"), scale=0.5),
        "conv_b": ParamMeta((w,), pdtype, ("mlp",), init="zeros"),
        "gate_a": ParamMeta((h, bw, bw), pdtype, ("heads", None, None), fan_in_axis=1),
        "bias_a": ParamMeta((w,), pdtype, ("mlp",), init="zeros"),
        "gate_x": ParamMeta((h, bw, bw), pdtype, ("heads", None, None), fan_in_axis=1),
        "bias_x": ParamMeta((w,), pdtype, ("mlp",), init="zeros"),
        "lam": ParamMeta((w,), pdtype, ("mlp",), init="lru_a"),
        "w_out": ParamMeta((w, d), pdtype, ("mlp", "embed")),
    }


def _block_diag(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, off: int = 0) -> torch.Tensor:
    """x: (..., H * bw) -> block-diagonal linear with (H, bw, bw) weights;
    of the result, the ``b.shape[-1]`` columns from ``off`` on, plus ``b``."""
    H, bw, _ = w.shape
    xs = x.reshape(*x.shape[:-1], H, bw)
    y = torch.einsum("...hi,hij->...hj", xs, w.to(x.dtype)).reshape(x.shape)
    n = b.shape[-1]
    if off or n != y.shape[-1]:
        y = y[..., off:off + n]
    return y + b.to(x.dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    W = w.shape[0]
    pad = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + pad[:, i : i + x.shape[1], :] * w[i]
    return out + b


def _gate_input(p, x: torch.Tensor):
    """(p, the gates' input, offset): under tensor parallelism, the
    replicated gate blocks made shared and cut to the heads that this
    rank's columns of ``x`` meet, and ``x`` widened to those heads'
    columns (all-gathered when the cut splits a head), with the offset of
    the rank's own columns in it."""
    res = hints.active_resolver()
    axes = res.axes("act_mlp") if res is not None else ()
    H, bw, _ = p["gate_a"].shape
    n = x.shape[-1]
    if not axes or n == H * bw:
        return p, x, 0
    lo = res.index("act_mlp") * n
    h0, h1 = lo // bw, -(-(lo + n) // bw)
    gates = hints.shared_param({"gate_a": p["gate_a"], "gate_x": p["gate_x"]}, "act_mlp")
    p = dict(p, gate_a=gates["gate_a"][h0:h1], gate_x=gates["gate_x"][h0:h1])
    if lo % bw or n % bw:  # the cut splits a head: gather the width
        x = comm.all_gather(x, res.mesh, axes, -1, length=H * bw)[..., h0 * bw:h1 * bw]
        return p, x, lo - h0 * bw
    return p, x, 0


def _gates(p, x: torch.Tensor):
    """Returns (a_t, gated input) in float32.  x: (..., W), this rank's
    columns under tensor parallelism."""
    f32 = torch.float32
    p, xh, off = _gate_input(p, x)
    xf = xh.to(f32)
    r = torch.sigmoid(_block_diag(xf, p["gate_a"].to(f32), p["bias_a"].to(f32), off))
    i = torch.sigmoid(_block_diag(xf, p["gate_x"].to(f32), p["bias_x"].to(f32), off))
    if xh is not x:
        xf = x.to(f32)
    log_a = -_C * F.softplus(p["lam"].to(f32)) * r
    # Where r saturates, a sits within a few ulps of 1 and one ulp of a^2
    # moves sqrt(1 - a^2) by up to ~40 %.  The JAX package, compiled, takes
    # a^2 as exp(2 log_a) (XLA folds exp(x) * exp(x)), with an exp that is
    # correctly rounded near 0, where torch's float32 exp is an ulp off at
    # ~4 % of arguments: so a and a^2 are float64 values, each rounded once.
    a64 = torch.exp(log_a.to(torch.float64))
    a = a64.to(f32)
    gated = torch.sqrt(torch.clamp(1.0 - (a64 * a64).to(f32), min=1e-12)) * (i * xf)
    return a, gated


def _scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of h_t = a_t h_{t-1} + b_t from h = 0:
    returns (prod a_1..t, h_t).  Hillis-Steele: log2(n) rounds of
    combine(l, r) = (a_l a_r, b_l a_r + b_r) with the element d before."""
    n = a.shape[1]
    d = 1
    while d < n:
        b = torch.cat([b[:, :d], b[:, :-d] * a[:, d:] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return a, b


def _chunk_body(h_in: torch.Tensor, ac: torch.Tensor, gc: torch.Tensor) -> torch.Tensor:
    """h over one chunk: h_t = P_t h_in + y0_t, P_t = prod(a_1..t), y0 the
    scan from h = 0."""
    P, y0 = _scan(ac, gc)
    return P * h_in[:, None, :] + y0


def rglru_forward(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) in the residual stream's layout -> the same."""
    x = hints.tp_input(x, RES, "act_mlp")
    dt = x.dtype
    gate = F.gelu(x @ p["w_gate"].to(dt), approximate="tanh")  # jax.nn.gelu's default
    xb = x @ p["w_x"].to(dt)
    xb = _causal_conv(xb, p["conv_w"].to(dt), p["conv_b"].to(dt))
    xb = hints.shard_hint(xb, ("act_batch", None, "act_mlp"))

    a, gx = _gates(p, xb)  # (B, S, W) float32

    B_, S, Wd = a.shape
    CH = min(_CHUNK, S)
    while S % CH:
        CH -= 1
    if CH < S:
        h_in = torch.zeros((B_, Wd), dtype=torch.float32, device=x.device)
        chunks = []
        for c0 in range(0, S, CH):
            h_c = checkpoint(_chunk_body, h_in, a[:, c0 : c0 + CH], gx[:, c0 : c0 + CH],
                             use_reentrant=False)
            h_in = h_c[:, -1]
            chunks.append(h_c)
        h = torch.cat(chunks, dim=1)
    else:
        _, h = _scan(a, gx)
    h = h.to(dt) * gate
    return hints.shard_hint(h @ p["w_out"].to(dt), RES, partial="act_mlp")


def rglru_cache_meta(cfg: ModelConfig, batch: int) -> dict:
    """Cache shapes of one RG-LRU layer, as ``meta``-device tensors."""
    w = _width(cfg)
    return {
        "h": torch.empty((batch, w), dtype=torch.float32, device="meta"),
        "conv": torch.empty((batch, cfg.ssm_conv - 1, w), dtype=cfg.activation_dtype, device="meta"),
    }


def rglru_decode(
    p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict, pos: torch.Tensor
) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, D) -> (out (B, 1, D), cache), the cache updated in place."""
    dt = x.dtype
    gate = F.gelu(x @ p["w_gate"].to(dt), approximate="tanh")
    xb = x @ p["w_x"].to(dt)  # (B, 1, W)
    window = torch.cat([cache["conv"], xb], dim=1)
    conv = torch.einsum("bwc,wc->bc", window, p["conv_w"].to(dt)) + p["conv_b"].to(dt)
    a, gx = _gates(p, conv)  # (B, W)
    h = cache["h"] * a + gx
    cache["h"].copy_(h)
    cache["conv"].copy_(window[:, 1:])
    out_h = h.to(dt)[:, None, :] * gate
    return hints.shard_hint(out_h @ p["w_out"].to(dt), RES, partial="act_mlp"), cache
