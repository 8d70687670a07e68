"""The check of a tridiagonalization: A = Q T Q^T with Q orthogonal.

Computed in float64 from the benchmark's own copy of the input and what
the timed call returned: the tridiagonal (d, e) and an ``X -> Q @ X`` built
from its reflectors (``qapply``).  Three numbers, the largest over the
calls checked:

* ``resid``: ||A (Q X) - Q (T X)||_F / ||A (Q X)||_F on ``probes`` Gaussian
  columns X drawn from the seed (A Q = Q T; a Gaussian X measures the
  Frobenius norm of the gap, so every row and column of Q and T counts);
* ``orth``: ||(Q X)^T (Q X) - X^T X||_F / ||X^T X||_F;
* ``eig``: max |eigenvalues of T - eigenvalues of A| / max |eigenvalues of
  A|, both in float64 (A's by ``torch.linalg.eigvalsh``, T's by LAPACK's
  tridiagonal solver through scipy).

No part of the program is imported: this file and ``qapply`` are plain.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import numpy as np
import torch

from . import qapply, sytrd

NUMBERS = ("resid", "orth", "eig")


def tridiag_times(d: torch.Tensor, e: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """T @ X for T = tridiag(e, d, e)."""
    Y = d[:, None] * X
    Y[1:] += e[:, None] * X[:-1]
    Y[:-1] += e[:, None] * X[1:]
    return Y


def numbers_one(A: torch.Tensor, d: torch.Tensor, e: torch.Tensor,
                apply_q: Callable[[torch.Tensor], torch.Tensor], X: torch.Tensor) -> Dict[str, float]:
    from scipy.linalg import eigvalsh_tridiagonal

    A64 = A.to(torch.float64)
    d64, e64 = d.to(torch.float64), e.to(torch.float64)
    r = X.shape[1]
    Y = apply_q(torch.cat([X, tridiag_times(d64, e64, X)], dim=1))
    QX, QTX = Y[:, :r], Y[:, r:]
    AQX = A64 @ QX
    G = X.mT @ X
    wa = torch.linalg.eigvalsh(A64).cpu().numpy()
    wt = eigvalsh_tridiagonal(d64.cpu().numpy(), e64.cpu().numpy())
    return {
        "resid": (torch.linalg.norm(AQX - QTX) / torch.linalg.norm(AQX)).item(),
        "orth": (torch.linalg.norm(QX.mT @ QX - G) / torch.linalg.norm(G)).item(),
        "eig": float(np.abs(np.sort(wt) - wa).max() / np.abs(wa).max()),
    }


def numbers(cases: Iterable[Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Callable]],
            probes: int, seed: int) -> Dict[str, float]:
    """The largest of each number over ``cases`` of (A, d, e, apply_q)."""
    worst: Dict[str, float] = {}
    for A, d, e, apply_q in cases:
        g = torch.Generator(device=A.device).manual_seed(seed)
        X = torch.randn((A.shape[-1], probes), generator=g, device=A.device, dtype=torch.float64)
        for k, v in numbers_one(A, d, e, apply_q, X).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def householder_q(out: dict, dtype=torch.float64):
    """``X -> Q @ X`` from a one-stage tridiagonalization's reflectors
    (``sytrd``'s V and tau), applied in ``dtype``."""
    V, tau = out["V"].to(dtype), out["tau"].to(dtype)
    return lambda X: sytrd.apply_q(V, tau, X.clone())


FORMS = {"two_stage": qapply.two_stage_q, "householder": householder_q}


def check(inputs: dict, kept: list, traffic: dict, seed: int) -> Dict[str, float]:
    """The numbers of the calls kept from the window: each a dict of the
    outputs as plain tensors, ``input``, the index of its matrix in the
    pool, and ``form``, how its reflectors encode Q (the program's two-stage
    factors, ``qapply.two_stage_q``'s keys, when absent)."""
    cases = ((inputs["pool"][k["input"]], k["d"], k["e"], FORMS[k.get("form", "two_stage")](k)) for k in kept)
    return numbers(cases, traffic["probes"], seed)
