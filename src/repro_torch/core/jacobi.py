"""Parallel cyclic Jacobi eigensolver (the dense baseline).

Port of ``repro.core.jacobi``: two-sided Jacobi with the round-robin
("tournament") ordering, so each round rotates n/2 disjoint (p, q) pairs
at once and a sweep is n-1 batched row/column updates.  It is an
independent oracle for the two-stage solver and ``method="jacobi"`` of the
plan API.  :func:`jacobi_eigh` takes leading batch dimensions; a matrix of
the batch stops rotating once it has converged, so each gets the sweeps it
would get alone.  One deliberate difference: each rotation is applied in
Rutishauser's correction form (see :func:`_one_round`), the same rotation
with less rounding.  With the reference's form, the fp32 error grows with
the number of rotations an entry takes: on the CPU its eigenvalues and
residual are ~1.5e-5 (n = 128) and ~3e-5 (n = 256) off, where this form
gives 1.6e-6 and 4.1e-6 (seeded N(0, 1) + transpose matrices).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.backend.trace import data_dependent, is_fake, repeated

__all__ = ["jacobi_eigh", "round_robin_pairs"]


def round_robin_pairs(n: int) -> np.ndarray:
    """Static tournament schedule: (n-1, n//2, 2) disjoint pair indices."""
    if n % 2:
        raise ValueError(f"round_robin_pairs requires even n, got n={n}")
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append([(players[i], players[n - 1 - i]) for i in range(n // 2)])
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(rounds, np.int32)


def _one_round(A: torch.Tensor, V: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> None:
    """Apply the disjoint rotations of one round to ``A`` and ``V`` in place."""
    app, aqq, apq = A[..., p, p], A[..., q, q], A[..., p, q]
    # Branch-free rotation (Golub & Van Loan 8.4).
    small = apq.abs() <= 1e-36
    theta = (aqq - app) / (2.0 * torch.where(small, 1.0, apq))
    t = torch.where(theta >= 0, 1.0, -1.0) / (theta.abs() + torch.sqrt(1.0 + theta * theta))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = torch.where(small, 0.0, t * c)
    # Each pair (x_p, x_q) -> (c x_p - s x_q, s x_p + c x_q), written as
    # x_p - s (x_q + r x_p) and x_q + s (x_p - r x_q) with r = s / (1 + c)
    # (Rutishauser): the same rotation, whose rounding shrinks with s, so
    # the many small rotations of the last sweeps add little error in fp32.
    r = s / (1.0 + c)
    sr, rr = s[..., :, None], r[..., :, None]
    Ap, Aq = A[..., p, :], A[..., q, :]  # row update: A <- J^T A
    A[..., p, :] = Ap - sr * (Aq + rr * Ap)
    A[..., q, :] = Aq + sr * (Ap - rr * Aq)
    sc, rc = s[..., None, :], r[..., None, :]
    Ap, Aq = A[..., :, p], A[..., :, q]  # column update: A <- A J
    A[..., :, p] = Ap - sc * (Aq + rc * Ap)
    A[..., :, q] = Aq + sc * (Ap - rc * Aq)
    A[..., p, q] = 0.0  # exact zeros at the annihilated entries
    A[..., q, p] = 0.0
    Vp, Vq = V[..., :, p], V[..., :, q]  # eigenvectors: V <- V J
    V[..., :, p] = Vp - sc * (Vq + rc * Vp)
    V[..., :, q] = Vq + sc * (Vp - rc * Vq)


def _off_norm(A: torch.Tensor) -> torch.Tensor:
    return torch.linalg.norm(A - torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1)), dim=(-2, -1))


def jacobi_eigh(A: torch.Tensor, max_sweeps: int = 16, tol: float = 1e-7):
    """Eigendecomposition of dense symmetric ``A`` (..., n, n) by parallel
    Jacobi.  Returns (eigenvalues ascending (..., n), eigenvectors as
    columns (..., n, n)).  ``n`` must be even."""
    shape, n = A.shape, A.shape[-1]
    rounds = torch.as_tensor(round_robin_pairs(n), dtype=torch.long, device=A.device)
    A = A.reshape(-1, n, n).clone()
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    bound = tol * torch.linalg.norm(A, dim=(-2, -1))
    active = _off_norm(A) > bound
    # Fake tensors have no values to test: every matrix takes every sweep.
    fake = is_fake(A)
    with data_dependent("core/jacobi.py:jacobi_eigh", f"{max_sweeps} sweeps over every matrix") as loop, \
            repeated(max_sweeps, A) as sweeps:
        for _ in sweeps:
            # A sweep rotates only the matrices still above their bound.
            idx = torch.arange(A.shape[0], device=A.device) if fake else torch.nonzero(active).squeeze(-1)
            if idx.numel() == 0:
                break
            loop.trip()
            A1, V1 = A[idx], V[idx]
            with repeated(len(rounds), A) as steps:
                for r in steps:
                    pq = rounds[r]
                    _one_round(A1, V1, pq[:, 0], pq[:, 1])
            A[idx], V[idx] = A1, V1
            active[idx] = _off_norm(A1) > bound[idx]
    lams, order = torch.sort(torch.diagonal(A, dim1=-2, dim2=-1), dim=-1, stable=True)
    V = torch.take_along_dim(V, order[..., None, :], dim=-1)
    return lams.reshape(shape[:-1]), V.reshape(shape)
