"""Eigensolvers for symmetric tridiagonal matrices.

Port of ``repro.core.tridiag_eig``: Sturm-sequence bisection for the
eigenvalues and pivoted inverse iteration plus a QR polish for the
eigenvectors.  The JAX package writes the recurrences as ``lax.scan`` and
batches them with ``jax.vmap``; here they are Python loops over the n rows,
each step vectorized across the eigenvalue lanes and across any leading
batch dimensions: ``d`` is (..., n), ``e`` (..., n-1), ``lams`` (..., k).
So one launch stream serves a whole bucket of matrices, as vmap does.
Per-matrix quantities stay per matrix (the pivot floor, the Gershgorin
bracket, the shift scale, the QR polish), and the steps are elementwise,
so a bucket gives each matrix the bits it gets alone.  One deliberate
difference: the shift perturbation of :func:`eigvecs_inverse_iteration`
stays bounded at large k (see there).  They run on the plan's device (the
JAX package has no Pallas kernel for them).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.backend.trace import count, data_dependent, is_fake, repeated

__all__ = [
    "sturm_count",
    "eigvalsh_tridiag",
    "eigvalsh_tridiag_range",
    "eigvecs_inverse_iteration",
    "eigh_tridiag",
]


def _pivmin(e: torch.Tensor, dtype) -> torch.Tensor:
    """Pivot floor per matrix: max(max e² · tiny, tiny), shape (...)."""
    tiny = torch.finfo(dtype).tiny
    if e.shape[-1] == 0:
        return torch.full(e.shape[:-1], tiny, dtype=dtype, device=e.device)
    return torch.clamp((e * e).amax(-1) * tiny, min=tiny)


def sturm_count(d: torch.Tensor, e: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Number of eigenvalues of tridiag(d, e) strictly below each x (int32).

    ``d`` (..., n), ``e`` (..., n-1), ``x`` (..., m); returns (..., m).  The
    safeguarded LDL^T sign-count recurrence (LAPACK dstebz style).
    """
    n = d.shape[-1]
    batch = torch.broadcast_shapes(d.shape[:-1], x.shape[:-1])
    zero = torch.zeros(e.shape[:-1] + (1,), dtype=d.dtype, device=d.device)
    # Rows first, so each step reads one contiguous (..., m) slice.
    e2 = torch.cat([zero, e * e], dim=-1).movedim(-1, 0)[..., None]
    pivmin = _pivmin(e, d.dtype)[..., None]
    neg_pivmin = -pivmin
    dmx = d.movedim(-1, 0)[..., None] - x[None]
    neg = torch.empty((n,) + batch + (x.shape[-1],), dtype=torch.bool, device=d.device)
    q = torch.ones(batch + x.shape[-1:], dtype=d.dtype, device=d.device)
    with repeated(n, d) as rows:
        for i in rows:
            q = torch.addcdiv(dmx[i], e2[i], q, value=-1.0)
            q = torch.where(q.abs() < pivmin, neg_pivmin, q)
            torch.lt(q, 0, out=neg[i])
    return neg.sum(0, dtype=torch.int32)


def _bisect_indices(d: torch.Tensor, e: torch.Tensor, ks: torch.Tensor, max_iter: int):
    """Bisection lanes for eigenvalue indices ``ks`` (..., m), ascending."""
    dtype = d.dtype
    zero = torch.zeros(e.shape[:-1] + (1,), dtype=dtype, device=d.device)
    r = torch.cat([zero, e.abs()], dim=-1) + torch.cat([e.abs(), zero], dim=-1)
    lo0 = (d - r).amin(-1)
    hi0 = (d + r).amax(-1)
    span = torch.clamp(hi0 - lo0, min=torch.finfo(dtype).eps)
    lanes = torch.broadcast_shapes(d.shape[:-1] + (1,), ks.shape)
    lo =(lo0 - 0.001 * span)[..., None].expand(lanes).clone()
    hi = (hi0 + 0.001 * span)[..., None].expand(lanes).clone()
    with repeated(max_iter, d) as steps:
        for _ in steps:
            mid = 0.5 * (lo + hi)
            go_up = sturm_count(d, e, mid) <= ks
            lo = torch.where(go_up, mid, lo)
            hi = torch.where(go_up, hi, mid)
    return 0.5 * (lo + hi)


def eigvalsh_tridiag(d: torch.Tensor, e: torch.Tensor, max_iter: int = 48) -> torch.Tensor:
    """All eigenvalues of tridiag(d, e), ascending, by parallel bisection."""
    n = d.shape[-1]
    return _bisect_indices(d, e, torch.arange(n, dtype=torch.int32, device=d.device), max_iter)


def eigvalsh_tridiag_range(
    d: torch.Tensor,
    e: torch.Tensor,
    *,
    start: int = 0,
    count: Optional[int] = None,
    max_iter: int = 48,
) -> torch.Tensor:
    """Eigenvalues ``start .. start+count-1`` (ascending) of tridiag(d, e);
    one bisection lane per requested eigenvalue.  Returns (..., count)."""
    n = d.shape[-1]
    count = n - start if count is None else count
    if not (0 <= start and start + count <= n and count >= 1):
        raise ValueError(f"invalid spectrum window [start={start}, count={count}) for n={n}")
    ks = start + torch.arange(count, dtype=torch.int32, device=d.device)
    return _bisect_indices(d, e, ks, max_iter)


def _tridiag_solve_pivoted(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, rhs: torch.Tensor):
    """Solve tridiag(dl, d, du) x = rhs with partial pivoting (dgtsv-style)
    for every lane at once.

    ``dl``/``du`` (..., n-1) are shared by a matrix's lanes; ``d`` and
    ``rhs`` are (..., n, m), one column per lane.  Returns x (..., n, m).
    """
    n, m = d.shape[-2:]
    batch = d.shape[:-2]
    dtype, dev = d.dtype, d.device
    tiny = torch.finfo(dtype).tiny * 16
    # Rows first: step i reads and writes contiguous (..., m) slices.
    d, rhs = d.movedim(-2, 0), rhs.movedim(-2, 0)
    if n == 1:
        b0 = d[0]
        x = rhs[0] / torch.where(b0.abs() < tiny, torch.where(b0 < 0, -tiny, tiny), b0)
        return x[None].movedim(0, -2)
    dl, du = dl.movedim(-1, 0)[..., None], du.movedim(-1, 0)[..., None]
    zrow = torch.zeros((1,) + batch + (m,), dtype=dtype, device=dev)
    lanes = batch + (m,)
    # Row i+1 of the matrix in columns (i, i+1, i+2) and its rhs, per step i.
    nxt = torch.stack(
        [
            dl.expand((n - 1,) + lanes),
            d[1:],
            torch.cat([du[1:], torch.zeros_like(du[:1])]).expand((n - 1,) + lanes),
            rhs[1:],
        ],
        dim=1,
    )
    absa = dl.abs()
    # cur = the running pivot-candidate row (b_cur, c_cur, 0, r_cur).
    cur = torch.stack([d[0], du[0].expand(lanes), zrow[0], rhs[0]])
    U = torch.empty((n - 1, 4) + lanes, dtype=dtype, device=dev)
    with repeated(n - 1, d) as steps:
        for i in steps:
            swap = absa[i] > cur[0].abs()
            P = torch.where(swap, nxt[i], cur)   # pivot row: (p1, p2, p3, pr)
            E = torch.where(swap, cur, nxt[i])   # eliminated row: (e1, e2, e3, er)
            p1 = P[0]
            U[i] = P
            torch.where(p1.abs() < tiny, torch.where(p1 < 0, -tiny, tiny), p1, out=U[i, 0])
            mfac = E[0] / U[i, 0]
            new = torch.addcmul(E[1:], mfac, P[1:], value=-1.0)  # (nb, nc, nr)
            cur = torch.cat([new[:2], zrow, new[2:]])
    b_last = cur[0]
    b_safe = torch.where(b_last.abs() < tiny, torch.where(b_last < 0, -tiny, tiny), b_last)
    x = torch.empty((n,) + lanes, dtype=dtype, device=dev)
    x[n - 1] = cur[3] / b_safe
    x2 = torch.zeros(lanes, dtype=dtype, device=dev)
    with repeated(n - 1, d) as steps:
        for j in steps:
            i = n - 2 - j
            u = U[i]
            t = torch.addcmul(u[3], u[1], x[i + 1], value=-1.0)
            t = torch.addcmul(t, u[2], x2, value=-1.0)
            torch.div(t, u[0], out=x[i])
            x2 = x[i + 1]
    return x.movedim(0, -2)


def _qr(X: torch.Tensor):
    """Thin QR of a stack X (..., n, k).

    A cluster's lanes share their shift offset and start vector, so X has
    exactly repeated columns.  LAPACK and CUDA's one-matrix QR give an
    orthogonal Q all the same; CUDA's batched QR does not (a Shampoo
    statistics block of rank 4 in 128 gets roots far off; measured by
    scripts/batched_qr_check.py), so on CUDA each matrix whose Q is not
    orthogonal to 1e-4 is factored again on its own (on fake tensors, which
    have no values, none is: the loop is listed as data-dependent).  While
    recording, the matrices checked count beside the loop's trips (the
    re-factors): ``core/tridiag_eig.py:_qr.checked`` and ``.trips``."""
    Q, R = torch.linalg.qr(X)
    if not X.is_cuda or X.ndim < 3:
        return Q, R
    k = Q.shape[-1]
    Qf, Rf, Xf = Q.reshape(-1, *Q.shape[-2:]), R.reshape(-1, k, k), X.reshape(-1, *X.shape[-2:])
    eye = torch.eye(k, dtype=Q.dtype, device=Q.device)
    bad = (Qf.mT @ Qf - eye).abs().amax((-2, -1)) > 1e-4
    count("core/tridiag_eig.py:_qr.checked", Qf.shape[0])
    with data_dependent("core/tridiag_eig.py:_qr", "no re-factor") as loop:
        for i in [] if is_fake(bad) else bad.nonzero().flatten().tolist():
            loop.trip()
            Qf[i], Rf[i] = torch.linalg.qr(Xf[i])
    return Qf.reshape(Q.shape), Rf.reshape(R.shape)


def eigvecs_inverse_iteration(
    d: torch.Tensor, e: torch.Tensor, lams: torch.Tensor, n_iter: int = 3
) -> torch.Tensor:
    """Eigenvectors of tridiag(d, e) for ascending eigenvalues ``lams``.

    One inverse-iteration lane per eigenvalue, then a thin QR that
    re-orthogonalizes clustered vectors.  ``d`` (..., n), ``e`` (..., n-1),
    ``lams`` (..., k); returns (..., n, k).

    The QR takes the lanes most isolated first (by the gap to their
    nearest neighbour in ``lams``), so a cluster's vectors, which inverse
    iteration cannot tell apart, are orthogonalized against the accurate
    ones and not the other way round.  The JAX package orthogonalizes in
    ascending order: on an ill-conditioned PSD matrix (a Shampoo
    statistics block, with a hundred eigenvalues within a few ulps of 0)
    that folds the cluster's noise into the top eigenvectors.
    """
    n = d.shape[-1]
    m = lams.shape[-1]
    dtype, dev = d.dtype, d.device
    i = torch.arange(n, dtype=dtype, device=dev)
    v0 = torch.cos(17.0 * (i + 1.0)) + 0.5
    v0 = v0 / torch.linalg.norm(v0)
    # A tiny perturbation splits exactly repeated shifts.  The JAX package
    # offsets lane j by (j - m/2)·8ulp·scale, which grows with m: at
    # n = 2048 it moves the outer shifts by more than the eigenvalue gap and
    # inverse iteration converges to a neighbour's vector (ROADMAP Queue 3).
    # Here the offset cycles over 8 values, so it stays a few ulps at any m.
    # Its scale is max|w| itself; the JAX package floors it at 1, which at
    # max|w| << 1 (Shampoo's statistics) moves the shifts past the gaps too.
    ulp = torch.finfo(dtype).eps
    scale = torch.clamp(lams.abs().amax(-1), min=torch.finfo(dtype).tiny)[..., None]
    lane = torch.arange(m, dtype=dtype, device=dev)
    lams_p = lams + (torch.remainder(lane, 8) - 3.5) * (8 * ulp) * scale
    dsh = d[..., :, None] - lams_p[..., None, :]
    V = v0[:, None].expand(dsh.shape).contiguous()
    tiny = torch.finfo(dtype).tiny
    with repeated(n_iter, d) as steps:
        for _ in steps:
            X = _tridiag_solve_pivoted(e, dsh, e, V)
            V = X / torch.clamp(torch.linalg.norm(X, dim=-2), min=tiny)[..., None, :]
    inf = torch.full_like(lams[..., :1], float("inf"))
    gaps = lams.diff(dim=-1)
    gap = torch.minimum(torch.cat([inf, gaps], -1), torch.cat([gaps, inf], -1))
    order = torch.argsort(-gap, dim=-1, stable=True)[..., None, :]
    Q, R = _qr(torch.take_along_dim(V, order, dim=-1))
    signs = torch.sign(torch.diagonal(R, dim1=-2, dim2=-1))
    signs = torch.where(signs == 0, 1.0, signs)
    return torch.empty_like(Q).scatter_(-1, order.expand_as(Q), Q * signs[..., None, :])


def eigh_tridiag(d: torch.Tensor, e: torch.Tensor, *, eigenvectors: bool = True, max_iter: int = 48):
    """Full symmetric tridiagonal eigendecomposition (ascending)."""
    lams = eigvalsh_tridiag(d, e, max_iter=max_iter)
    if not eigenvectors:
        return lams
    return lams, eigvecs_inverse_iteration(d, e, lams)
