"""Plain application of the two-stage tridiagonalization's orthogonal factor.

A frozen copy of the port's plain ``apply_q_left`` (``core/band_reduction``)
and ``apply_q2`` (``core/bulge_chasing``), in whatever dtype the caller
passes (the checks pass float64).  A = Q1 B Q1^T with Q1 = H_1 ... H_P, one
block reflector I - V_p T_p V_p^T a panel of ``b`` columns; B = Q2 T Q2^T
with Q2 the chase's reflectors in execution order, logged by wavefront as
``vs`` (W, A, b), ``taus`` (W, A) and ``row0`` (W, A), the first row of each
reflector's support (``n`` for an inactive slot, whose tau is 0).  So
A = Q T Q^T with Q = Q1 Q2.
"""
from __future__ import annotations

import torch


def apply_q1(V: torch.Tensor, T: torch.Tensor, b: int, X: torch.Tensor) -> torch.Tensor:
    """Q1 @ X: the panels from last to first.  V (n, P*b), T (P, b, b)."""
    for p in range(T.shape[0] - 1, -1, -1):
        Vp = V[:, p * b : (p + 1) * b]
        X = X - Vp @ (T[p] @ (Vp.mT @ X))
    return X


def apply_q2(vs: torch.Tensor, taus: torch.Tensor, row0: torch.Tensor, n: int, b: int,
             X: torch.Tensor) -> torch.Tensor:
    """Q2 @ X: the wavefronts from last to first; one wavefront's
    reflectors have disjoint supports, so each wavefront is one update."""
    m = X.shape[1]
    # b zero rows below X: inactive reflectors (row0 == n) land there.
    Xp = torch.zeros((n + b, m), dtype=X.dtype, device=X.device)
    Xp[:n] = X
    rows_all = torch.clamp(row0.long()[..., None] + torch.arange(b, device=X.device), max=n + b - 1)
    for w in range(vs.shape[0] - 1, -1, -1):
        rows = rows_all[w].reshape(-1)
        v = vs[w]
        Xg = Xp[rows].view(v.shape[0], b, m)
        proj = torch.einsum("ab,abm->am", v, Xg)
        upd = taus[w][:, None, None] * v[:, :, None] * proj[:, None, :]
        Xp.index_add_(0, rows, upd.reshape(-1, m), alpha=-1.0)
    return Xp[:n].clone()


def two_stage_q(out: dict, dtype=torch.float64):
    """``X -> Q @ X`` from a two-stage tridiagonalization's factors (the
    dict of plain tensors an entry keeps), applied in ``dtype``."""
    V, T = out["V1"].to(dtype), out["T1"].to(dtype)
    vs, taus = out["vs"].to(dtype), out["taus"].to(dtype)
    row0, n, b1, b2 = out["row0"], out["n"], out["b1"], out["b2"]

    def apply(X: torch.Tensor) -> torch.Tensor:
        return apply_q1(V, T, b1, apply_q2(vs, taus, row0, n, b2, X))

    return apply
