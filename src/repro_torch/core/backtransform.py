"""Blocked compact-WY back-transform: V = Q1 Q2 V_T.

Port of ``repro.core.backtransform``.

* **Q1** — each DBR block's q panel reflectors merge into one rank-q·b
  reflector (``Tm``), applied with plain ``torch.matmul`` (the JAX package
  leaves this product to XLA, outside Pallas).
* **Q2** — the chase log is regrouped sweep-major: within sweep ``s`` the
  reflectors ``(s, k)`` have disjoint row supports ``[s+1+kb, s+1+(k+1)b)``,
  so a sweep is one batched update.  That is the ``backtransform_wy``
  registry op: :func:`backtransform_wy_xla` is its plain version and
  ``csrc/backtransform.cu`` its kernel.

The reflector structure is static (it depends on n, b and nb only), so the
Q1 merge and apply, the Q2 regroup and the ``backtransform_wy`` op also take
tensors with leading batch dimensions: a bucket of matrices is merged,
regrouped and applied in one pass (:func:`apply_q2_blocked_many`), with one
``backtransform_wy`` call for the bucket.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.backend import registry
from repro_torch.backend.trace import repeated, span

from .band_reduction import BandReflectors, apply_q_left
from .bulge_chasing import ChaseLog, _kmax_table

__all__ = [
    "merge_band_reflectors",
    "apply_q_left_blocked",
    "sweep_major_log",
    "backtransform_wy_xla",
    "apply_q2_blocked",
    "apply_q2_blocked_many",
]


def _merge_block_ts(Vg: torch.Tensor, Ts: torch.Tensor, b: int) -> torch.Tensor:
    """Fuse q per-panel T factors into one (q·b, q·b) block-reflector T.
    ``Vg`` (..., n, q·b), ``Ts`` (..., q, b, b)."""
    q = Ts.shape[-3]
    w = q * b
    Tm = torch.zeros(Ts.shape[:-3] + (w, w), dtype=Vg.dtype, device=Vg.device)
    Tm[..., :b, :b] = Ts[..., 0, :, :]
    for j in range(1, q):
        c0 = j * b
        Vj = Vg[..., :, c0 : c0 + b]
        Tm[..., :c0, c0 : c0 + b] = -Tm[..., :c0, :c0] @ ((Vg[..., :, :c0].mT @ Vj) @ Ts[..., j, :, :])
        Tm[..., c0 : c0 + b, c0 : c0 + b] = Ts[..., j, :, :]
    return Tm


def merge_band_reflectors(refl: BandReflectors) -> BandReflectors:
    """``refl`` with per-block merged T factors (``Tm``) filled in.  ``V``
    and ``T`` may carry leading batch dimensions (a bucket's stacked
    reflectors, which share their block structure)."""
    if refl.Tm is not None:
        return refl
    if not refl.blocks:
        if refl.T.shape[-3] == 0:  # n <= b: no panels, Q1 == I
            return BandReflectors(V=refl.V, T=refl.T, b=refl.b, blocks=(), Tm=())
        raise ValueError("BandReflectors carries no block structure")
    b = refl.b
    Tms = tuple(
        _merge_block_ts(refl.V[..., :, p0 * b : (p0 + q) * b], refl.T[..., p0 : p0 + q, :, :], b)
        for p0, q in refl.blocks
    )
    return BandReflectors(V=refl.V, T=refl.T, b=b, blocks=refl.blocks, Tm=Tms)


def apply_q_left_blocked(
    refl: BandReflectors, X: torch.Tensor, transpose: bool = False
) -> torch.Tensor:
    """Q1 @ X (or Q1^T @ X) with one rank-q·b update per DBR block; leading
    batch dimensions of ``refl`` and ``X`` broadcast."""
    if refl.Tm is None:
        if not refl.blocks:
            return apply_q_left(refl, X, transpose)
        refl = merge_band_reflectors(refl)
    b = refl.b
    order = range(len(refl.blocks))
    if not transpose:
        order = reversed(order)
    for g in order:
        p0, q = refl.blocks[g]
        V = refl.V[..., :, p0 * b : (p0 + q) * b]
        Tg = refl.Tm[g].mT if transpose else refl.Tm[g]
        X = X - V @ (Tg @ (V.mT @ X))
    return X


def _sweep_shape(n: int, b: int) -> Tuple[int, int]:
    """(S, K): sweep count and max reflectors per sweep."""
    S = max(n - 2, 0)
    K = (n - 3) // b + 1 if n >= 3 else 0
    return S, K


def _sweep_major(vs: torch.Tensor, taus: torch.Tensor, n: int, b: int, sequential: bool):
    """The regroup of :func:`sweep_major_log` on log tensors with leading
    batch dimensions: ``vs`` (..., W, A, b) of a wavefront log, or
    (..., L, b) of a sequential one (``sequential``)."""
    S, K = _sweep_shape(n, b)
    if S == 0 or K == 0:
        raise ValueError(f"no bulge-chase reflectors for n={n}")
    kmax = _kmax_table(n, b)
    s_idx = np.arange(S)[:, None]
    k_idx = np.arange(K)[None, :]
    valid = k_idx <= kmax[:S, None]
    dev = vs.device
    mask = torch.as_tensor(valid, device=dev)
    if sequential:  # entries in (s-major, k-minor) execution order
        first = np.concatenate([[0], np.cumsum(kmax[:S] + 1)[:-1]])
        i_t = torch.as_tensor(np.where(valid, first[:, None] + k_idx, 0), device=dev)
        vs_sw, taus_sw = vs[..., i_t, :], taus[..., i_t]
    else:  # entry (s, k) at wavefront 3s + k, slot k // 3
        w_t = torch.as_tensor(np.where(valid, 3 * s_idx + k_idx, 0), device=dev)
        a_t = torch.as_tensor(np.where(valid, k_idx // 3, 0), device=dev)
        vs_sw, taus_sw = vs[..., w_t, a_t, :], taus[..., w_t, a_t]
    return torch.where(mask[..., None], vs_sw, 0.0), torch.where(mask, taus_sw, 0.0)


def sweep_major_log(log: ChaseLog):
    """Reindex a :class:`ChaseLog` into sweep-major order.

    Returns ``(vs (S, K, b), taus (S, K))``: entry (s, k) is the reflector
    with row support ``[s+1+kb, s+1+(k+1)b)``.  A wavefront log (W, A, b)
    holds it at wavefront ``3s+k``, slot ``k//3``; a sequential log (L, b)
    at its place in execution order.  Entries past ``kmax(s)`` are zero
    (tau == 0 no-ops).
    """
    return _sweep_major(log.vs, log.taus, log.n, log.b, log.vs.ndim == 2)


def backtransform_wy_xla(
    X: torch.Tensor,
    vs: torch.Tensor,
    taus: torch.Tensor,
    *,
    b: int,
    group: Optional[int] = None,
    transpose: bool = False,
) -> torch.Tensor:
    """Plain ``backtransform_wy``: Q2 @ X (or Q2^T @ X) from the sweep-major
    log, one batched (K, b)-row update per sweep; X (..., n, m) with vs
    (..., S, K, b) and taus (..., S, K) applies each matrix's log to its X.

    ``group`` is accepted for the op's signature: the JAX reference applies
    each sweep in groups of ``group`` reflectors, which does not change the
    arithmetic (the supports are disjoint), so the whole sweep goes at once.
    """
    S, K, _ = vs.shape[-3:]
    n, m = X.shape[-2:]
    Xp = torch.zeros(X.shape[:-2] + (n + K * b, m), dtype=X.dtype, device=X.device)
    Xp[..., :n, :] = X
    order = range(S) if transpose else range(S - 1, -1, -1)
    with repeated(S, X) as sweeps:
        for j in sweeps:
            s = order[j]
            P = Xp[..., s + 1 : s + 1 + K * b, :].unflatten(-2, (K, b))
            V = vs[..., s, :, :]
            proj = torch.einsum("...kb,...kbm->...km", V, P)
            P -= taus[..., s, :, None, None] * V[..., :, :, None] * proj[..., :, None, :]
    return Xp[..., :n, :].clone()


def apply_q2_blocked(
    log: ChaseLog,
    X: torch.Tensor,
    transpose: bool = False,
    *,
    group: Optional[int] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Q2 @ X (or Q2^T @ X) through the ``backtransform_wy`` registry op."""
    bucket = ChaseLog(vs=log.vs[None], taus=log.taus[None], row0=log.row0[None], n=log.n, b=log.b)
    return apply_q2_blocked_many(bucket, X[None], transpose, group=group, backend=backend)[0]


def apply_q2_blocked_many(
    log: ChaseLog,
    X: torch.Tensor,
    transpose: bool = False,
    *,
    group: Optional[int] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """:func:`apply_q2_blocked` for a bucket: matrix i's log applied to
    ``X[i]`` (X is (B, n, m)); ``log`` is the bucket's (leading dimension
    B, as ``band_to_tridiag`` returns it for a bucket).  The log is
    regrouped sweep-major in one pass (a span ``q2_regroup``), and the op
    runs once for the bucket."""
    n, b = log.n, log.b
    S, K = _sweep_shape(n, b)
    if S == 0 or K == 0:
        return X.clone()  # n < 3: the chase made no reflectors, Q2 == I
    # A sequential log is (B, L, b), a wavefront log (B, W, A, b).
    with span("q2_regroup", X):
        vs, taus = _sweep_major(log.vs, log.taus, n, b, log.vs.ndim == X.ndim)
    fn = registry.resolve("backtransform_wy", backend or registry.default_backend(X.device))
    return fn(X, vs, taus, b=b, group=group, transpose=transpose)
