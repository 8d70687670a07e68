"""Direct (one-stage) Householder tridiagonalization: the paper's baseline.

Port of ``repro.core.direct_tridiag``: column-by-column Householder
reduction (LAPACK ``sytrd`` without blocking), n-2 dependent steps, each
dominated by a symmetric matrix-vector product, the BLAS2-bound algorithm
the paper's two-stage method replaces.  A plan takes it when blocking
collapses to b = 1 (odd n) or when asked (``method="direct"``).  Every
function takes leading batch dimensions, so a bucket runs as one stream of
batched steps.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .householder import house

__all__ = ["direct_tridiagonalize", "DirectReflectors", "apply_q_direct"]


class DirectReflectors(NamedTuple):
    V: torch.Tensor      # (..., n, n): column j is the reflector of step j
    taus: torch.Tensor   # (..., n)


def direct_tridiagonalize(A: torch.Tensor, return_reflectors: bool = False):
    """Reduce symmetric ``A`` (..., n, n) to tridiagonal form by direct
    Householder steps.  Returns ``T`` or ``(T, DirectReflectors)`` with
    A = Q T Q^T.  ``A`` is not modified."""
    n = A.shape[-1]
    batch = A.shape[:-2]
    A = A.clone()
    V = torch.zeros(batch + (n, n), dtype=A.dtype, device=A.device)
    taus = torch.zeros(batch + (n,), dtype=A.dtype, device=A.device)
    for j in range(max(n - 2, 0)):
        v_tail, tau, beta = house(A[..., j + 1 :, j])
        v = V[..., :, j]
        v[..., j + 1 :] = v_tail
        taus[..., j] = tau
        # Two-sided rank-2 update A <- H A H, H = I - tau v v^T; the
        # product A v is the BLAS2 symv that bounds the method.
        Av = (A @ v[..., :, None])[..., 0]
        vAv = (v * Av).sum(-1)
        w = tau[..., None] * (Av - 0.5 * (tau * vAv)[..., None] * v)
        A -= v[..., :, None] * w[..., None, :] + w[..., :, None] * v[..., None, :]
        # Exact zeros below the subdiagonal of column j, and in row j.
        A[..., j + 1, j] = beta
        A[..., j + 2 :, j] = 0.0
        A[..., j, :] = A[..., :, j].clone()
    if return_reflectors:
        return A, DirectReflectors(V=V, taus=taus)
    return A


def apply_q_direct(refl: DirectReflectors, X: torch.Tensor, transpose: bool = False):
    """Q @ X (or Q^T @ X) for Q = H_0 H_1 ... H_{n-3}."""
    n = refl.V.shape[-1]
    steps = range(n - 2) if transpose else range(n - 3, -1, -1)
    for j in steps:
        v = refl.V[..., :, j : j + 1]
        X = X - refl.taus[..., j, None, None] * v * (v.mT @ X)
    return X
