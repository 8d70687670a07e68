"""Mamba2 block: SSD (state-space duality) with a chunked matmul scan (port
of ``repro.models.mamba2``; plain torch, as the JAX module is plain jnp).

The SSD algorithm (Dao & Gu, 2024) evaluates the selective-SSM recurrence

    state_t = exp(dt_t A) state_{t-1} + dt_t * B_t (x) x_t
    y_t     = C_t . state_t + D * x_t

as (1) block-diagonal intra-chunk attention-like products and (2) a short
scan over chunk-level states.  Heads H share B/C within ``ngroups`` groups
(G=1 for mamba2-370m).

Dtypes follow the JAX module: the products' operands are rounded to the
activation dtype and summed in float32 (its ``preferred_element_type``),
the decay and statistics math is float32.

Decode keeps (state, conv window) caches, O(H*P*N) per layer, updated in
place so that a decode step can be captured as one CUDA graph.

Under a sharding resolver whose ``act_mlp`` is a mesh axis (tensor
parallelism), each rank holds whole heads: its column blocks of ``w_z``,
``w_x``, ``conv_x_*`` and ``norm_scale`` and its row block of
``out_proj`` (the ``mlp`` axis, ``d_inner / m`` a multiple of the head
width), and takes its heads' entries of the replicated ``w_dt``,
``A_log``, ``dt_bias`` and ``D``; ``B`` / ``C`` are computed whole on
every rank from replicated weights (their gradients summed over the
model axis).  The gated RMSNorm over all of ``d_inner`` sums its squares
over the model axis, and ``out_proj``'s partial sums are reduced (or
reduce-scattered under sequence parallelism, whose sequence is gathered
on the way in).  Decode splits its caches the same way: the state on
heads, the conv window on channels, the B/C window whole.  This is what
GSPMD computes for the JAX package's rule tables (``mlp`` split;
``state``, ``conv``, ``heads`` replicated).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel import hints

from .config import ModelConfig
from .layers import apply_norm
from .params import ParamMeta

__all__ = [
    "mamba2_meta",
    "mamba2_forward",
    "mamba2_decode",
    "mamba2_cache_meta",
    "ssd_chunked",
    "ssd_reference",
]


def mamba2_meta(cfg: ModelConfig, pdtype) -> dict:
    """Per-segment projections and convs (z | x | B | C | dt), split as the
    JAX package splits them (so leaf order and Shampoo blocks match)."""
    d = cfg.d_model
    di = cfg.d_inner
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    h = cfg.ssm_nheads
    gn = g * n
    return {
        "w_z": ParamMeta((d, di), pdtype, ("embed", "mlp")),
        "w_x": ParamMeta((d, di), pdtype, ("embed", "mlp")),
        "w_B": ParamMeta((d, gn), pdtype, ("embed", "state")),
        "w_C": ParamMeta((d, gn), pdtype, ("embed", "state")),
        "w_dt": ParamMeta((d, h), pdtype, ("embed", "heads")),
        "conv_x_w": ParamMeta((cfg.ssm_conv, di), pdtype, ("conv", "mlp"), scale=0.5),
        "conv_x_b": ParamMeta((di,), pdtype, ("mlp",), init="zeros"),
        "conv_B_w": ParamMeta((cfg.ssm_conv, gn), pdtype, ("conv", "state"), scale=0.5),
        "conv_B_b": ParamMeta((gn,), pdtype, ("state",), init="zeros"),
        "conv_C_w": ParamMeta((cfg.ssm_conv, gn), pdtype, ("conv", "state"), scale=0.5),
        "conv_C_b": ParamMeta((gn,), pdtype, ("state",), init="zeros"),
        "A_log": ParamMeta((h,), pdtype, ("heads",), init="ssm_alog"),
        "dt_bias": ParamMeta((h,), pdtype, ("heads",), init="ssm_dtbias"),
        "D": ParamMeta((h,), pdtype, ("heads",), init="ones"),
        "norm_scale": ParamMeta((di,), pdtype, ("mlp",), init="ones"),
        "out_proj": ParamMeta((di, d), pdtype, ("mlp", "embed")),
    }


def _silu_conv(xc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S + SiLU.  xc: (B, S, Ch); w: (W, Ch)."""
    W = w.shape[0]
    pad = F.pad(xc, (0, 0, W - 1, 0))
    out = torch.zeros_like(xc)
    for i in range(W):  # W is tiny (4): unrolled shifted adds, no gather
        out = out + pad[:, i : i + xc.shape[1], :] * w[i]
    return F.silu(out + b)


def _segsum(dtA: torch.Tensor) -> torch.Tensor:
    """seg[i, j] = dtA_{j+1} + ... + dtA_i for i >= j, -inf above the
    diagonal.  dtA: (..., Q) -> (..., Q, Q).

    Each segment is summed on its own (a cumsum down the columns of the
    masked (Q, Q) repeat), not taken as cs_i - cs_j: the JAX package's
    difference of two cumsums loses |cs| * 2^-24 to cancellation, and its
    random-weight decays reach |cs| ~ 1e4 in a chunk (mamba2-370m: dt up to
    ~20, A down to -16), which puts ~1e-3 errors in every decay.  The mask
    is applied to the EXPONENT (not exp's result), so the backward sees no
    0 * inf."""
    Q = dtA.shape[-1]
    ones = torch.ones((Q, Q), dtype=torch.bool, device=dtA.device)
    x = dtA[..., :, None].expand(*dtA.shape, Q)             # x[i, j] = dtA_i
    seg = torch.cumsum(torch.where(ones.tril(-1), x, 0.0), dim=-2)
    return torch.where(ones.tril(), seg, float("-inf"))


def ssd_chunked(
    X: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H)   positive
    A: torch.Tensor,    # (H,)        negative
    Bm: torch.Tensor,   # (B, S, G, N)
    Cm: torch.Tensor,   # (B, S, G, N)
    chunk: int,
) -> torch.Tensor:
    B_, S, H, P = X.shape
    G, N = Bm.shape[-2], Bm.shape[-1]
    rep = H // G
    Q = min(chunk, S)
    while S % Q:  # largest divisor of S <= chunk (ragged sequences)
        Q -= 1
    nc = S // Q

    f32 = torch.float32

    def op(t):  # a product's operand: rounded to the activation dtype, summed in float32
        return t.to(X.dtype).to(f32)

    Xc = X.reshape(B_, nc, Q, H, P)
    dtc = dt.reshape(B_, nc, Q, H).to(f32)
    Bc = op(Bm.reshape(B_, nc, Q, G, N))
    Cc = op(Cm.reshape(B_, nc, Q, G, N))
    Xg = op(Xc.reshape(B_, nc, Q, G, rep, P))

    dtA = dtc * A.to(f32)                                # (B, nc, Q, H)
    cs = torch.cumsum(dtA, dim=2)                        # inclusive
    total = cs[:, :, -1, :]                              # (B, nc, H)
    seg = _segsum(dtA.permute(0, 1, 3, 2))               # (B, nc, H, Q, Q)

    # ---- intra-chunk (block-diagonal "attention") -----------------------
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)      # (B, nc, G, Q, Q)
    L = torch.exp(seg).reshape(B_, nc, G, rep, Q, Q)     # exp(cs_i - cs_j), i >= j
    M = CB[:, :, :, None] * L                            # (B, nc, G, rep, Q, Q)
    M = M * dtc.reshape(B_, nc, Q, G, rep).permute(0, 1, 3, 4, 2)[:, :, :, :, None, :]
    Y_intra = torch.einsum("bcgrqk,bckgrp->bcqgrp", op(M), Xg)

    # ---- chunk states ----------------------------------------------------
    # S_c = sum_j exp(total - cs_j) dt_j  B_j (x) x_j     -> (B, nc, G, rep, N, P)
    decay_out = torch.exp(seg[..., -1, :]).permute(0, 1, 3, 2)  # (B, nc, Q, H)
    w_j = op((decay_out * dtc).reshape(B_, nc, Q, G, rep))
    Sc = torch.einsum("bcqgn,bcqgrp->bcgrnp", Bc, w_j[..., None] * Xg)

    # ---- inter-chunk scan: the state BEFORE each chunk --------------------
    decay_chunk = torch.exp(total).reshape(B_, nc, G, rep)
    state = torch.zeros((B_, G, rep, N, P), dtype=f32, device=X.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * decay_chunk[:, c, :, :, None, None] + Sc[:, c]
    state_prev = torch.stack(prev, dim=1)                # (B, nc, G, rep, N, P)

    # Y_inter[i] = C_i . (exp(cs_i) * state_prev)
    decay_in = op(torch.exp(cs).reshape(B_, nc, Q, G, rep))
    Y_inter = torch.einsum("bcqgn,bcgrnp->bcqgrp", Cc, op(state_prev)) * decay_in[..., None]

    Y = (Y_intra + Y_inter).reshape(B_, S, H, P)
    return Y.to(X.dtype)


def ssd_reference(X, dt, A, Bm, Cm):
    """Sequential recurrence oracle (a loop over time)."""
    B_, S, H, P = X.shape
    G, N = Bm.shape[-2], Bm.shape[-1]
    rep = H // G
    f32 = torch.float32
    state = torch.zeros((B_, H, N, P), dtype=f32, device=X.device)
    ys = []
    for t in range(S):
        dt_t = dt[:, t].to(f32)                                    # (B, H)
        a_t = torch.exp(dt_t * A.to(f32))
        bg = Bm[:, t].repeat_interleave(rep, dim=1).to(f32)        # (B, H, N)
        cg = Cm[:, t].repeat_interleave(rep, dim=1).to(f32)
        outer = dt_t[..., None, None] * torch.einsum("bhn,bhp->bhnp", bg, X[:, t].to(f32))
        state = state * a_t[..., None, None] + outer
        ys.append(torch.einsum("bhn,bhnp->bhp", cg, state))
    return torch.stack(ys, dim=1).to(X.dtype)


def _pre_ssm(p, cfg: ModelConfig, x: torch.Tensor):
    dt_ = x.dtype
    z = x @ p["w_z"].to(dt_)
    xs = x @ p["w_x"].to(dt_)
    Bm = x @ p["w_B"].to(dt_)
    Cm = x @ p["w_C"].to(dt_)
    dt_raw = x @ p["w_dt"].to(dt_)
    xs = hints.shard_hint(xs, ("act_batch", None, "act_mlp"))
    xs = _silu_conv(xs, p["conv_x_w"].to(dt_), p["conv_x_b"].to(dt_))
    Bm = _silu_conv(Bm, p["conv_B_w"].to(dt_), p["conv_B_b"].to(dt_))
    Cm = _silu_conv(Cm, p["conv_C_w"].to(dt_), p["conv_C_b"].to(dt_))
    return z, xs, Bm, Cm, dt_raw


RES = ("act_batch", "act_res_seq", None)  # the residual stream's layout
_SHARED = ("w_B", "w_C", "conv_B_w", "conv_B_b", "conv_C_w", "conv_C_b", "w_dt", "A_log", "dt_bias", "D")


def _tp_params(p: dict, cfg: ModelConfig) -> dict:
    """``p`` with the weights that every rank holds whole made shared over
    the model axis (their gradients summed) and the per-head ones cut to
    this rank's heads; ``p`` itself without tensor parallelism."""
    res = hints.active_resolver()
    if res is None or not res.axes("act_mlp"):
        return p
    h = p["w_x"].shape[-1] // cfg.ssm_headdim
    h0 = res.index("act_mlp") * h
    q = dict(p, **hints.shared_param({k: p[k] for k in _SHARED}, "act_mlp"))
    q["w_dt"] = q["w_dt"][:, h0:h0 + h]
    for k in ("A_log", "dt_bias", "D"):
        q[k] = q[k][h0:h0 + h]
    return q


def _groups(cfg: ModelConfig, res, h: int):
    """The B/C groups of this rank's ``h`` heads, as a slice."""
    g, H = cfg.ssm_ngroups, cfg.ssm_nheads
    if h == H:
        return slice(0, g)
    rep = H // g
    h0 = res.index("act_mlp") * h
    if g > 1 and (h % rep or h0 % rep):
        raise ValueError(f"{h} heads a rank from {h0} do not hold whole B/C groups of {rep} heads")
    return slice(h0 // rep, -(-(h0 + h) // rep))


def _post_ssm(p, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    gated = y * F.silu(z)
    if gated.shape[-1] == cfg.d_inner:
        normed = apply_norm({"scale": p["norm_scale"]}, gated, "rmsnorm")
    else:  # the RMS over all of d_inner: each rank's sum of squares, summed
        xf = gated.to(torch.float32)
        ss = hints.tp_sum(torch.sum(torch.square(xf), dim=-1, keepdim=True), "act_mlp")
        normed = (xf * torch.rsqrt(ss / cfg.d_inner + 1e-6) * p["norm_scale"].to(torch.float32)).to(y.dtype)
    return normed @ p["out_proj"].to(y.dtype)


def _dt_and_A(p, dt_raw: torch.Tensor):
    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"].to(torch.float32))
    return dt, -torch.exp(p["A_log"].to(torch.float32))


def mamba2_forward(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) in the residual stream's layout -> the same."""
    x = hints.tp_input(x, RES, "act_mlp")
    p = _tp_params(p, cfg)
    B, S, D = x.shape
    n, P = cfg.ssm_state, cfg.ssm_headdim
    z, xseg, Bseg, Cseg, dt_raw = _pre_ssm(p, cfg, x)
    h = xseg.shape[-1] // P  # this rank's heads
    grp = _groups(cfg, hints.active_resolver(), h)
    xs = xseg.reshape(B, S, h, P)
    Bm = Bseg.reshape(B, S, -1, n)[:, :, grp]
    Cm = Cseg.reshape(B, S, -1, n)[:, :, grp]
    dt, A = _dt_and_A(p, dt_raw)
    y = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xs
    out = _post_ssm(p, cfg, y.reshape(B, S, h * P), z)
    return hints.shard_hint(out, RES, partial="act_mlp")


# ----------------------------------------------------------------------
# Decode
# ----------------------------------------------------------------------

def mamba2_cache_meta(cfg: ModelConfig, batch: int) -> dict:
    """Cache shapes of one Mamba2 layer, as ``meta``-device tensors: the
    float32 SSM state and the last ``ssm_conv - 1`` conv inputs."""
    di, g, n = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    h, P = cfg.ssm_nheads, cfg.ssm_headdim
    dt = cfg.activation_dtype
    return {
        "state": torch.empty((batch, h, n, P), dtype=torch.float32, device="meta"),
        "conv": torch.empty((batch, cfg.ssm_conv - 1, di), dtype=dt, device="meta"),
        "conv_bc": torch.empty((batch, cfg.ssm_conv - 1, 2 * g * n), dtype=dt, device="meta"),
    }


def mamba2_decode(
    p: dict, cfg: ModelConfig, x: torch.Tensor, cache: dict, pos: torch.Tensor
) -> Tuple[torch.Tensor, dict]:
    """x: (B, 1, D) -> (out (B, 1, D), cache), the cache updated in place.
    Under tensor parallelism the cache holds this rank's heads (state) and
    channels (conv window); the B/C window is whole, and replicated over
    the batch axes too, of which the rank reads and writes its own rows
    (the JAX package's GSPMD gathers every rank's new rows back into the
    replicated leaf; no rank reads another's)."""
    B = x.shape[0]
    g, n, P = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_headdim
    gn = g * n
    dt_ = x.dtype
    p = _tp_params(p, cfg)

    z = x @ p["w_z"].to(dt_)
    x_new = x @ p["w_x"].to(dt_)
    B_new = x @ p["w_B"].to(dt_)
    C_new = x @ p["w_C"].to(dt_)
    dt_raw = x @ p["w_dt"].to(dt_)
    h = x_new.shape[-1] // P  # this rank's heads
    grp = _groups(cfg, hints.active_resolver(), h)

    conv_bc = cache["conv_bc"]
    if conv_bc.shape[0] != B:  # replicated over the batch axes (launch.cache_specs): this rank's rows
        res = hints.active_resolver()
        r0 = res.index(res.batch_axes()) * B
        conv_bc = conv_bc[r0:r0 + B]
    win_x = torch.cat([cache["conv"], x_new], dim=1)  # (B, W, di)
    win_bc = torch.cat([conv_bc, torch.cat([B_new, C_new], dim=-1)], dim=1)
    xs_c = F.silu(torch.einsum("bwc,wc->bc", win_x, p["conv_x_w"].to(dt_)) + p["conv_x_b"].to(dt_))
    wbc = torch.cat([p["conv_B_w"].to(dt_), p["conv_C_w"].to(dt_)], dim=1)
    bbc = torch.cat([p["conv_B_b"].to(dt_), p["conv_C_b"].to(dt_)])
    bc_c = F.silu(torch.einsum("bwc,wc->bc", win_bc, wbc) + bbc)
    cache["conv"].copy_(win_x[:, 1:])
    conv_bc.copy_(win_bc[:, 1:])

    xs = xs_c.reshape(B, h, P)
    # Each group's B / C for its heads (an expand: no host sync, so the
    # step can be captured in a CUDA graph).
    Bg = bc_c[..., :gn].reshape(B, g, n)[:, grp]
    Cg = bc_c[..., gn:].reshape(B, g, n)[:, grp]
    gl = Bg.shape[1]
    Bm = Bg.reshape(B, gl, 1, n).expand(B, gl, h // gl, n).reshape(B, h, n)
    Cm = Cg.reshape(B, gl, 1, n).expand(B, gl, h // gl, n).reshape(B, h, n)
    dt, A = _dt_and_A(p, dt_raw[:, 0])  # (B, h), (h,)
    a_t = torch.exp(dt * A)
    outer = dt[..., None, None] * torch.einsum(
        "bhn,bhp->bhnp", Bm.to(torch.float32), xs.to(torch.float32))
    state = cache["state"] * a_t[..., None, None] + outer
    cache["state"].copy_(state)
    y = torch.einsum("bhn,bhnp->bhp", Cm.to(torch.float32), state).to(dt_)
    y = y + p["D"].to(dt_)[None, :, None] * xs
    out = _post_ssm(p, cfg, y.reshape(B, 1, h * P), z)
    return hints.shard_hint(out, RES, partial="act_mlp"), cache
