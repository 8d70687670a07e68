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
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.backend import registry

from .band_reduction import BandReflectors, apply_q_left
from .bulge_chasing import ChaseLog, _kmax_table

__all__ = [
    "merge_band_reflectors",
    "apply_q_left_blocked",
    "sweep_major_log",
    "backtransform_wy_xla",
    "apply_q2_blocked",
]


def _merge_block_ts(Vg: torch.Tensor, Ts: torch.Tensor, b: int) -> torch.Tensor:
    """Fuse q per-panel T factors into one (q·b, q·b) block-reflector T."""
    q = Ts.shape[0]
    w = q * b
    Tm = torch.zeros((w, w), dtype=Vg.dtype, device=Vg.device)
    Tm[:b, :b] = Ts[0]
    for j in range(1, q):
        c0 = j * b
        Vj = Vg[:, c0 : c0 + b]
        Tm[:c0, c0 : c0 + b] = -Tm[:c0, :c0] @ ((Vg[:, :c0].T @ Vj) @ Ts[j])
        Tm[c0 : c0 + b, c0 : c0 + b] = Ts[j]
    return Tm


def merge_band_reflectors(refl: BandReflectors) -> BandReflectors:
    """``refl`` with per-block merged T factors (``Tm``) filled in."""
    if refl.Tm is not None:
        return refl
    if not refl.blocks:
        if refl.T.shape[0] == 0:  # n <= b: no panels, Q1 == I
            return BandReflectors(V=refl.V, T=refl.T, b=refl.b, blocks=(), Tm=())
        raise ValueError("BandReflectors carries no block structure")
    b = refl.b
    Tms = tuple(
        _merge_block_ts(refl.V[:, p0 * b : (p0 + q) * b], refl.T[p0 : p0 + q], b)
        for p0, q in refl.blocks
    )
    return BandReflectors(V=refl.V, T=refl.T, b=b, blocks=refl.blocks, Tm=Tms)


def apply_q_left_blocked(
    refl: BandReflectors, X: torch.Tensor, transpose: bool = False
) -> torch.Tensor:
    """Q1 @ X (or Q1^T @ X) with one rank-q·b update per DBR block."""
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
        V = refl.V[:, p0 * b : (p0 + q) * b]
        Tg = refl.Tm[g].T if transpose else refl.Tm[g]
        X = X - V @ (Tg @ (V.T @ X))
    return X


def _sweep_shape(n: int, b: int) -> Tuple[int, int]:
    """(S, K): sweep count and max reflectors per sweep."""
    S = max(n - 2, 0)
    K = (n - 3) // b + 1 if n >= 3 else 0
    return S, K


def sweep_major_log(log: ChaseLog):
    """Reindex a wavefront :class:`ChaseLog` into sweep-major order.

    Returns ``(vs (S, K, b), taus (S, K))``: entry (s, k) is the reflector
    with row support ``[s+1+kb, s+1+(k+1)b)``, found at wavefront ``3s+k``,
    slot ``k//3``.  Entries past ``kmax(s)`` are zero (tau == 0 no-ops).
    """
    n, b = log.n, log.b
    S, K = _sweep_shape(n, b)
    if S == 0 or K == 0:
        raise ValueError(f"no bulge-chase reflectors for n={n}")
    if log.vs.ndim != 3:
        raise NotImplementedError(
            "sequential chase logs are not ported yet: ROADMAP Queue 1 item 8"
        )
    kmax = _kmax_table(n, b)
    s_idx = np.arange(S)[:, None]
    k_idx = np.arange(K)[None, :]
    valid = k_idx <= kmax[:S, None]
    w_idx = np.where(valid, 3 * s_idx + k_idx, 0)
    a_idx = np.where(valid, k_idx // 3, 0)
    dev = log.vs.device
    w_t = torch.as_tensor(w_idx, device=dev)
    a_t = torch.as_tensor(a_idx, device=dev)
    mask = torch.as_tensor(valid, device=dev)
    vs = torch.where(mask[..., None], log.vs[w_t, a_t], 0.0)
    taus = torch.where(mask, log.taus[w_t, a_t], 0.0)
    return vs, taus


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
    log, one batched (K, b)-row update per sweep.

    ``group`` is accepted for the op's signature: the JAX reference applies
    each sweep in groups of ``group`` reflectors, which does not change the
    arithmetic (the supports are disjoint), so the whole sweep goes at once.
    """
    S, K, _ = vs.shape
    n, m = X.shape
    Xp = torch.zeros((n + K * b, m), dtype=X.dtype, device=X.device)
    Xp[:n] = X
    order = range(S) if transpose else range(S - 1, -1, -1)
    for s in order:
        P = Xp[s + 1 : s + 1 + K * b].view(K, b, m)
        V = vs[s]
        proj = torch.einsum("kb,kbm->km", V, P)
        P -= taus[s][:, None, None] * V[:, :, None] * proj[:, None, :]
    return Xp[:n].clone()


def apply_q2_blocked(
    log: ChaseLog,
    X: torch.Tensor,
    transpose: bool = False,
    *,
    group: Optional[int] = None,
    backend: Optional[str] = None,
) -> torch.Tensor:
    """Q2 @ X (or Q2^T @ X) through the ``backtransform_wy`` registry op."""
    n, b = log.n, log.b
    S, K = _sweep_shape(n, b)
    if S == 0 or K == 0:
        return X.clone()  # n < 3: the chase made no reflectors, Q2 == I
    vs, taus = sweep_major_log(log)
    fn = registry.resolve("backtransform_wy", backend or registry.default_backend(X.device))
    return fn(X, vs, taus, b=b, group=group, transpose=transpose)
