"""A plain one-stage blocked Householder tridiagonalization (LAPACK's
``sytrd`` with ``latrd`` panels), on a stack of symmetric matrices.

It stands in the program's place as the correctness control: run in
float32 with ``tf32=True``, each trailing update ``A -= V W^T + W V^T``
takes its operands rounded to TF32 (10 mantissa bits, to nearest, as the
tensor cores' ``cvt.rna`` does) and sums in float32, which is what a TF32
matrix product computes.  That is the step that would tempt a faster
program: kernel A's trailing update in one TF32 product instead of three.
Everything else runs in the dtype given.  In float64 it is an accurate
reference (the tests hold it against ``torch.linalg.eigvalsh``).

A = Q T Q^T with Q = H_0 H_1 ... H_{n-2}, H_j = I - tau_j v_j v_j^T, v_j
zero above row j+1 and 1 at row j+1.
"""
from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits, ties away from 0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _house(x: torch.Tensor):
    """Reflector of x (..., m) onto beta e_0: (v with v[0] = 1, tau, beta)."""
    alpha = x[..., 0]
    sigma = (x[..., 1:] * x[..., 1:]).sum(-1)
    norm = torch.sqrt(alpha * alpha + sigma)
    beta = torch.where(alpha >= 0, -norm, norm)
    trivial = sigma == 0
    safe_beta = torch.where(trivial, torch.ones_like(beta), beta)
    tau = torch.where(trivial, torch.zeros_like(beta), (beta - alpha) / safe_beta)
    denom = torch.where(trivial, torch.ones_like(alpha), alpha - beta)
    v = x / denom[..., None]
    v[..., 0] = 1.0
    beta = torch.where(trivial, alpha, beta)
    return v, tau, beta


def tridiagonalize(A: torch.Tensor, nb: int = 32, tf32: bool = False):
    """Symmetric A (..., n, n) -> (d (..., n), e (..., n-1), V (..., n, n-1),
    tau (..., n-1)): column j of V is v_j."""
    A = A.clone()
    n = A.shape[-1]
    lead = A.shape[:-2]
    d = torch.empty(lead + (n,), dtype=A.dtype, device=A.device)
    e = torch.empty(lead + (max(n - 1, 0),), dtype=A.dtype, device=A.device)
    Vall = torch.zeros(lead + (n, max(n - 1, 0)), dtype=A.dtype, device=A.device)
    tau_all = torch.zeros(lead + (max(n - 1, 0),), dtype=A.dtype, device=A.device)
    k = 0
    while k < n - 1:
        p = min(nb, n - 1 - k)
        V = torch.zeros(lead + (n - k, p), dtype=A.dtype, device=A.device)
        W = torch.zeros_like(V)
        for i in range(p):
            j = k + i  # global column; local row r = j - k
            col = A[..., j:, j, None]
            if i:
                col = col - V[..., i:, :i] @ W[..., i, :i, None] - W[..., i:, :i] @ V[..., i, :i, None]
            col = col[..., 0]
            d[..., j] = col[..., 0]
            v, tau, beta = _house(col[..., 1:])
            e[..., j] = beta
            V[..., i + 1 :, i] = v
            Vall[..., j + 1 :, j] = v
            tau_all[..., j] = tau
            y = A[..., j + 1 :, j + 1 :] @ v[..., None]
            if i:
                y = (y - V[..., i + 1 :, :i] @ (W[..., i + 1 :, :i].mT @ v[..., None])
                     - W[..., i + 1 :, :i] @ (V[..., i + 1 :, :i].mT @ v[..., None]))
            w = tau[..., None] * y[..., 0]
            w = w - (0.5 * tau * (w * v).sum(-1))[..., None] * v
            W[..., i + 1 :, i] = w
        r = p  # the trailing block starts p rows into the panel's rows
        Vt, Wt = V[..., r:, :], W[..., r:, :]
        if tf32:
            Vt, Wt = round_tf32(Vt), round_tf32(Wt)
        A[..., k + p :, k + p :] -= Vt @ Wt.mT + Wt @ Vt.mT
        k += p
    d[..., n - 1] = A[..., n - 1, n - 1]
    return d, e, Vall, tau_all


def apply_q(V: torch.Tensor, tau: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Q @ X for the reflectors of :func:`tridiagonalize` (one matrix)."""
    for j in range(V.shape[-1] - 1, -1, -1):
        v = V[j + 1 :, j]
        X[j + 1 :] -= tau[j] * v[:, None] * (v @ X[j + 1 :])[None, :]
    return X

