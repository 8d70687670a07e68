"""Plain version of the in-kernel panel QR (``repro.kernels.panel``).

:func:`panel_qr_body` is the column recurrence that kernel A
(``csrc/fused_panel.cu``, device function ``panel_qr_lapack``) runs inside
its panel phase, written as tensor code: b Householder steps with LAPACK
signs (beta = -sign(alpha)·|x|), then the ``larft`` T recurrence.  The
CUDA kernel is held against it and against ``panel_qr_geqrf``.
"""
from __future__ import annotations

import torch

__all__ = ["panel_qr_body"]


def panel_qr_body(A: torch.Tensor, b: int, *, lapack_sign: bool = True):
    """Householder QR of the (m, b) panel ``A``.  Returns ``(V, T, taus, R)``.

    ``lapack_sign=True`` is LAPACK ``larfg`` (the sign the fused first stage
    uses); ``False`` is the JAX package's historical beta = +|x|.
    """
    m = A.shape[0]
    A = A.clone()
    dtype, dev = A.dtype, A.device
    rows = torch.arange(m, device=dev)
    V = torch.zeros((m, b), dtype=dtype, device=dev)
    taus = torch.zeros((b,), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    for j in range(b):
        colv = A[:, j]
        alpha = colv[j]
        sigma = torch.where(rows > j, colv * colv, 0.0).sum()
        mu = torch.sqrt(alpha * alpha + sigma)
        degenerate = sigma == 0
        if lapack_sign:
            sign_a = torch.where(alpha >= 0, 1.0, -1.0).to(dtype)
            beta_nd = -sign_a * mu
            safe_beta = torch.where(beta_nd == 0, one, beta_nd)
            tau = torch.where(degenerate, 0.0, (beta_nd - alpha) / safe_beta)
            beta = torch.where(degenerate, alpha, beta_nd)
            denom = alpha - beta_nd
            v0_safe = torch.where(denom == 0, one, denom)
        else:
            safe_denom = torch.where(alpha + mu == 0, one, alpha + mu)
            v0 = torch.where(alpha <= 0, alpha - mu, -sigma / safe_denom)
            v0_safe = torch.where(degenerate, one, v0)
            tau = torch.where(
                degenerate, 0.0, 2.0 * v0_safe * v0_safe / (sigma + v0_safe * v0_safe)
            )
            beta = torch.where(degenerate, alpha, mu)
        v = torch.where(rows == j, 1.0, torch.where(rows > j, colv / v0_safe, 0.0))
        wv = v @ A[:, j:]
        A[:, j:] -= tau * torch.outer(v, wv)
        A[:, j] = torch.where(rows == j, beta, torch.where(rows < j, A[:, j], 0.0))
        V[:, j] = v
        taus[j] = tau
    VtV = V.T @ V
    T = torch.zeros((b, b), dtype=dtype, device=dev)
    for j in range(b):
        if j:
            T[:j, j] = -taus[j] * (T[:j, :j] @ VtV[:j, j])
        T[j, j] = taus[j]
    return V, T, taus, A[:b, :].clone()
