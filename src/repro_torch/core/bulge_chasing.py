"""Bulge chasing: symmetric band matrix -> tridiagonal (wavefront schedule).

Port of ``repro.core.bulge_chasing`` for both generations.  Op (s, k)
of sweep ``s`` eliminates column ``s`` (k = 0) or ``s+1+(k-1)b`` (k >= 1)
with one reflector on rows ``[s+1+kb, s+1+(k+1)b)``, as a two-sided update
of the 3b-wide window starting at row ``s+1+(k-1)b``.  Op (s, k) runs at
wavefront ``w = 3s + k``; the ops of one wavefront touch windows that share
at most one corner element that neither changes, so a wavefront is one
batched update.

:func:`chase_wavefront` is the executor: the plain version of the
``bulge_wavefront`` and ``bulge_chase`` ops, whose kernel is
``csrc/bulge.cu``, and the unfused generation's chase when a log is needed.
:func:`chase_sequential` is the oracle (``chase="sequential"``): the ops one
at a time in the paper's serial order, with an (L, b) log; :func:`apply_q2`
applies either log reflector by reflector (``backtransform="scan"``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.backend import registry
from repro_torch.backend.trace import repeated

from .householder import house

__all__ = [
    "ChaseLog",
    "chase_sequential",
    "chase_wavefront",
    "chase_wavefront_slices",
    "band_to_tridiag",
    "apply_q2",
    "extract_tridiag",
    "num_wavefronts",
    "max_active_sweeps",
    "wavefront_schedule",
]


@dataclasses.dataclass
class ChaseLog:
    """Reflector log of the bulge chase's orthogonal factor Q2.

    B = Q2 T Q2^T with Q2 = H_1 H_2 ... H_L in execution order.  Wavefront
    logs are ``vs`` (W, A, b), ``taus`` (W, A), ``row0`` (W, A) int32: the
    global start row of each reflector's support, sentinel ``n`` for an
    inactive slot (whose ``tau`` is 0 and ``v`` is e_0).  Sequential logs
    are (L, b), (L,) and (L,), one entry per op in execution order.
    """

    vs: torch.Tensor
    taus: torch.Tensor
    row0: torch.Tensor
    n: int
    b: int


def _kmax_table(n: int, b: int) -> np.ndarray:
    return np.array([(n - 3 - s) // b for s in range(max(n - 2, 1))], np.int32)


def num_wavefronts(n: int, b: int) -> int:
    if n < 3:
        return 0
    return 3 * (n - 3) + 1


def max_active_sweeps(n: int, b: int) -> int:
    return int((_kmax_table(n, b)[0] + 1 + 2) // 3 + 1) if n >= 3 else 1


def _pad_sizes(n: int, b: int):
    off = b                       # margin before the matrix (k=0 windows)
    scratch0 = off + n + 2 * b    # inactive slots read/write a zero block
    total = scratch0 + 3 * b
    return off, scratch0, total


def wavefront_schedule(n: int, b: int):
    """Static (W, A) tables of the chase: ``k`` (step), ``active`` (bool),
    ``r0`` (window start in the padded matrix of :func:`_pad_sizes`) and
    ``row0`` (reflector support start, ``n`` when inactive)."""
    A = max_active_sweeps(n, b)
    W = num_wavefronts(n, b)
    off, scratch0, _ = _pad_sizes(n, b)
    kmax = _kmax_table(n, b)
    w = np.arange(W, dtype=np.int64)[:, None]
    a = np.arange(A, dtype=np.int64)[None, :]
    s = w // 3 - a
    k = w - 3 * s
    s_safe = np.clip(s, 0, n - 3)
    active = (s >= 0) & (s <= n - 3) & (k >= 0) & (k <= kmax[s_safe])
    r0 = np.where(active, off + s + 1 + (k - 1) * b, scratch0)
    row0 = np.where(active, s + 1 + k * b, n).astype(np.int32)
    return k, active, r0, row0


def _window_op(W: torch.Tensor, k: torch.Tensor, b: int):
    """One chase op on each (3b, 3b) window of the batch ``W`` (A, 3b, 3b).

    The reflector acts on local rows [b, 2b); the eliminated column is local
    ``b-1`` for k == 0 and ``0`` for k >= 1.  Zero windows are no-ops.
    Returns ``(W_new, v (A, b), tau (A,))``.
    """
    w3 = 3 * b
    dev = W.device
    li = torch.arange(w3, device=dev)
    elim = torch.where(k == 0, b - 1, 0)
    x = torch.take_along_dim(W[:, b : 2 * b, :], elim[:, None, None].expand(-1, b, 1), dim=2)[..., 0]
    v, tau, beta = house(x)
    u = torch.zeros((W.shape[0], w3), dtype=W.dtype, device=dev)
    u[:, b : 2 * b] = v
    Mv = (W @ u[:, :, None])[..., 0]
    vMv = (u * Mv).sum(-1)
    wvec = tau[:, None] * (Mv - 0.5 * (tau * vMv)[:, None] * u)
    Wn = W - u[:, :, None] * wvec[:, None, :] - wvec[:, :, None] * u[:, None, :]
    in_rows = (li >= b) & (li < 2 * b)
    exact = torch.where(li[None, :] == b, beta[:, None], 0.0)
    col_mask = in_rows[None, :, None] & (li[None, None, :] == elim[:, None, None])
    Wn = torch.where(col_mask, exact[:, :, None], Wn)
    Wn = torch.where(col_mask.transpose(1, 2), exact[:, None, :], Wn)
    return Wn, v, tau


def _trivial_log(B: torch.Tensor, b: int) -> ChaseLog:
    n = B.shape[0]
    bb = max(b, 1)
    return ChaseLog(
        vs=torch.zeros((1, bb), dtype=B.dtype, device=B.device),
        taus=torch.zeros((1,), dtype=B.dtype, device=B.device),
        row0=torch.full((1,), n, dtype=torch.int32, device=B.device),
        n=n,
        b=bb,
    )


def chase_sequential(B: torch.Tensor, b: int, return_log: bool = False):
    """The oracle executor: ops one at a time in the paper's serial order
    (sweep-major).  Returns ``T`` or ``(T, ChaseLog)`` with an (L, b) log."""
    n = B.shape[0]
    if n < 3 or b <= 1:
        out = B.clone()
        return (out, _trivial_log(B, b)) if return_log else out
    dev, dtype = B.device, B.dtype
    off, _, total = _pad_sizes(n, b)
    w3 = 3 * b
    kmax = _kmax_table(n, b)
    sk = [(s, k) for s in range(n - 2) for k in range(int(kmax[s]) + 1)]
    Bp = torch.zeros((total, total), dtype=dtype, device=dev)
    Bp[off : off + n, off : off + n] = B
    ks = torch.as_tensor([k for _, k in sk], device=dev)
    vs = torch.empty((len(sk), b), dtype=dtype, device=dev)
    taus = torch.empty((len(sk),), dtype=dtype, device=dev)
    for i, (s, k) in enumerate(sk):
        r0 = off + s + 1 + (k - 1) * b
        win = Bp[r0 : r0 + w3, r0 : r0 + w3]
        Wn, v, tau = _window_op(win[None], ks[i : i + 1], b)
        win.copy_(Wn[0])
        vs[i] = v[0]
        taus[i] = tau[0]
    out = Bp[off : off + n, off : off + n].clone()
    if not return_log:
        return out
    row0 = torch.as_tensor([s + 1 + k * b for s, k in sk], dtype=torch.int32, device=dev)
    return out, ChaseLog(vs=vs, taus=taus, row0=row0, n=n, b=b)


def chase_wavefront(B: torch.Tensor, b: int, return_log: bool = False):
    """The wavefront executor: per wavefront, the windows of all
    A = ``max_active_sweeps`` slots are gathered from a zero-padded copy of
    ``B``, updated by one batched :func:`_window_op` and scattered back
    (the windows are disjoint; inactive slots all target one zero scratch
    block and write zeros).  Returns ``T`` or ``(T, ChaseLog)`` with the log
    in (W, A, b) layout."""
    n = B.shape[0]
    if n < 3 or b <= 1:
        out = B.clone()
        return (out, _trivial_log(B, b)) if return_log else out
    dev, dtype = B.device, B.dtype
    off, _, total = _pad_sizes(n, b)
    w3 = 3 * b
    k_np, _, r0_np, row0_np = wavefront_schedule(n, b)
    W_total, A = k_np.shape
    ks = torch.as_tensor(k_np, device=dev)
    rows_all = torch.as_tensor(r0_np, device=dev)[:, :, None] + torch.arange(w3, device=dev)
    Bp = torch.zeros((total, total), dtype=dtype, device=dev)
    Bp[off : off + n, off : off + n] = B
    if return_log:
        vs = torch.empty((W_total, A, b), dtype=dtype, device=dev)
        taus = torch.empty((W_total, A), dtype=dtype, device=dev)
    with repeated(W_total, B) as wavefronts:
        for w in wavefronts:
            rows = rows_all[w]
            ri, ci = rows[:, :, None], rows[:, None, :]
            Wn, v, tau = _window_op(Bp[ri, ci], ks[w], b)
            Bp[ri, ci] = Wn
            if return_log:
                vs[w] = v
                taus[w] = tau
    out = Bp[off : off + n, off : off + n].clone()
    if not return_log:
        return out
    row0 = torch.as_tensor(row0_np, device=dev)
    return out, ChaseLog(vs=vs, taus=taus, row0=row0, n=n, b=b)


def chase_wavefront_slices(B: torch.Tensor, b: int, return_log: bool = False):
    """Plain ``bulge_wavefront``: :func:`chase_wavefront`.

    JAX's ``chase_wavefront_slices`` differs from its ``chase_wavefront``
    only in the write-back (one ``dynamic_update_slice`` per slot, because
    XLA lowers the scatter badly off the TPU) and is bitwise equal to it.
    In eager PyTorch the scatter is one call and a per-slot write-back a
    Python loop over the slots, so the port runs one executor under both
    names.
    """
    return chase_wavefront(B, b, return_log)


def band_to_tridiag(
    B: torch.Tensor,
    b: int,
    *,
    method: str = "wavefront",
    return_log: bool = False,
    mode: Optional[str] = None,
    backend: Optional[str] = None,
):
    """Reduce a symmetric band matrix (dense storage) to tridiagonal form.

    ``method="sequential"`` runs the oracle :func:`chase_sequential` (plain
    tensor code on any device).  ``mode`` (default: the process-wide
    ``registry.default_tridiag()``) picks the wavefront generation.
    ``mode="fused"`` runs the ``bulge_wavefront`` registry op (kernel B on
    the ``cuda`` backend, log included).  ``mode="unfused"`` is the legacy
    composition, as in the JAX package: the ``bulge_chase`` op (kernel B
    without the log) for values only, and :func:`chase_wavefront` (plain
    tensor code on any device) when the log is needed.  ``backend``
    defaults to ``cuda`` for a CUDA tensor and ``torch`` on the CPU.
    """
    if method == "sequential":
        return chase_sequential(B, b, return_log)
    if method != "wavefront":
        raise ValueError(f"unknown bulge chasing method: {method!r}")
    mode = mode or registry.default_tridiag()
    if mode not in ("fused", "unfused"):
        raise ValueError(f"unknown tridiag mode: {mode!r}")
    backend = backend or registry.default_backend(B.device)
    if mode == "fused":
        return registry.resolve("bulge_wavefront", backend)(B, b, return_log=return_log)
    if not return_log:
        return registry.resolve("bulge_chase", backend)(B, b)
    return chase_wavefront(B, b, return_log=True)


def extract_tridiag(T: torch.Tensor):
    """(diagonal, subdiagonal) of a (numerically) tridiagonal matrix
    (..., n, n): (..., n) and (..., n-1)."""
    return (
        torch.diagonal(T, dim1=-2, dim2=-1).clone(),
        torch.diagonal(T, offset=-1, dim1=-2, dim2=-1).clone(),
    )


def apply_q2(log: ChaseLog, X: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Q2 @ X (or Q2^T @ X) from a reflector log, reflector by reflector.

    Q2 = H_1 ... H_L in execution order, so Q2 @ X runs the log backwards
    and Q2^T @ X forwards.  A wavefront log applies each wavefront's
    reflectors as one batched update (their row supports are disjoint); a
    sequential log is a run of wavefronts of one reflector.
    """
    n, b = log.n, log.b
    m = X.shape[1]
    # b zero rows below X: inactive reflectors (row0 == n) land there.
    Xp = torch.zeros((n + b, m), dtype=X.dtype, device=X.device)
    Xp[:n] = X
    vs, taus, row0 = log.vs, log.taus, log.row0
    if vs.ndim == 2:
        vs, taus, row0 = vs[:, None], taus[:, None], row0[:, None]
    rows_all = torch.clamp(row0.long()[..., None] + torch.arange(b, device=X.device), max=n + b - 1)
    order = range(vs.shape[0]) if transpose else range(vs.shape[0] - 1, -1, -1)
    for w in order:
        rows = rows_all[w].reshape(-1)
        v = vs[w]
        Xg = Xp[rows].view(v.shape[0], b, m)
        proj = torch.einsum("ab,abm->am", v, Xg)
        upd = taus[w][:, None, None] * v[:, :, None] * proj[:, None, :]
        Xp.index_add_(0, rows, upd.reshape(-1, m), alpha=-1.0)
    return Xp[:n].clone()
