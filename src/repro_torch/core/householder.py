"""Householder reflector utilities (LAPACK-style, branch-free tensor code).

A reflector H = I - tau v v^T with v[0] = 1 maps a vector x to
(beta, 0, ..., 0)^T.  Port of ``repro.core.householder``; every function
here also takes a batch of vectors in its leading dimensions, which is how
the bulge chase applies one wavefront's windows at once.
"""
from __future__ import annotations

import torch

__all__ = [
    "house",
    "house_masked",
    "apply_house_left",
    "apply_house_right",
    "apply_house_both",
    "larft",
    "wy_apply_left",
    "wy_apply_right",
]


def house(x: torch.Tensor):
    """Householder reflector for the last axis of ``x``.

    Returns ``(v, tau, beta)`` with ``v[..., 0] == 1`` such that
    ``(I - tau v v^T) x = beta * e1`` (beta = +|x|, the JAX package's
    convention).  A zero tail gives ``tau == 0`` and ``beta == x[0]``.
    """
    alpha = x[..., 0]
    tail = x[..., 1:]
    sigma = (tail * tail).sum(-1)
    mu = torch.sqrt(alpha * alpha + sigma)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    safe_denom = torch.where(alpha + mu == 0, one, alpha + mu)
    v0 = torch.where(alpha <= 0, alpha - mu, -sigma / safe_denom)
    degenerate = sigma == 0
    v0_safe = torch.where(degenerate, one, v0)
    tau = torch.where(
        degenerate,
        torch.zeros_like(alpha),
        2.0 * v0_safe * v0_safe / (sigma + v0_safe * v0_safe),
    )
    beta = torch.where(degenerate, alpha, mu)
    v_tail = torch.where(
        degenerate[..., None], torch.zeros_like(tail), tail / v0_safe[..., None]
    )
    v = torch.cat([torch.ones_like(alpha)[..., None], v_tail], dim=-1)
    return v, tau, beta


def house_masked(x: torch.Tensor, mask: torch.Tensor):
    """:func:`house` of ``x`` with the entries where ``mask`` is False taken
    as exact zeros; ``v`` is zero there too.  A dead head entry gives
    ``tau == 0`` and ``beta == 0``."""
    x = torch.where(mask, x, 0.0)
    v, tau, beta = house(x)
    v = torch.where(mask, v, 0.0)
    head_live = mask[..., 0]
    return v, torch.where(head_live, tau, 0.0), torch.where(head_live, beta, x[..., 0])


def apply_house_left(M: torch.Tensor, v: torch.Tensor, tau) -> torch.Tensor:
    """(I - tau v v^T) @ M: ``v`` acts on the rows of ``M``."""
    return M - tau * torch.outer(v, v @ M)


def apply_house_right(M: torch.Tensor, v: torch.Tensor, tau) -> torch.Tensor:
    """M @ (I - tau v v^T): ``v`` acts on the columns of ``M``."""
    return M - tau * torch.outer(M @ v, v)


def apply_house_both(M: torch.Tensor, v: torch.Tensor, tau) -> torch.Tensor:
    """(I - tau v v^T) M (I - tau v v^T) for symmetric ``M``, as the
    symmetric rank-2 update M - v w^T - w v^T with
    w = tau (M v - (tau/2)(v^T M v) v)."""
    Mv = M @ v
    w = tau * (Mv - 0.5 * tau * (v @ Mv) * v)
    return M - torch.outer(v, w) - torch.outer(w, v)


def larft(V: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Upper-triangular block-reflector factor T (LAPACK ``larft``):
    H_1 H_2 ... H_k = I - V T V^T for unit lower-trapezoidal ``V`` (..., m, k)."""
    k = V.shape[-1]
    VtV = V.mT @ V
    T = torch.zeros(V.shape[:-2] + (k, k), dtype=V.dtype, device=V.device)
    for j in range(k):
        if j:
            T[..., :j, j] = -taus[..., j, None] * (T[..., :j, :j] @ VtV[..., :j, j : j + 1])[..., 0]
        T[..., j, j] = taus[..., j]
    return T


def wy_apply_left(M: torch.Tensor, V: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Q^T @ M with Q = I - V T V^T."""
    return M - V @ (T.T @ (V.T @ M))


def wy_apply_right(M: torch.Tensor, V: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """M @ Q with Q = I - V T V^T."""
    return M - (M @ V) @ (T @ V.T)
