"""The JAX package's keyword entry points over the plan API.

Port of ``repro.core.eigh``:

    eigh(A, b=8, nb=64)       ==  plan_for(A, EvdConfig(b=8, nb=64))(A)
    eigvalsh(A)               ==  plan_for(A, cfg).eigvals(A)
    eigh_batched(As)          ==  solve_many(As, cfg)
    inverse_pth_root(A, p)    ==  plan_for(A, cfg).inverse_pth_root(A, p)

Each builds (or finds in the plan cache) the equivalent plan on ``A``'s
device.  The solver is imported when a function runs, not here, because
``repro_torch.solver`` imports the stages of this package.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "tridiagonalize",
    "eigh",
    "eigvalsh",
    "eigh_batched",
    "eigvalsh_batched",
    "inverse_pth_root",
]


def tridiagonalize(A: torch.Tensor, **kw):
    """``repro_torch.solver.tridiagonalize`` (re-exported here)."""
    from repro_torch.solver.plan import tridiagonalize as impl

    return impl(A, **kw)


def _as_config(
    config,
    *,
    b: Optional[int],
    nb: Optional[int],
    method: str,
    chase: str = "wavefront",
    max_sweeps: int = 16,
):
    from repro_torch.solver import EvdConfig

    if config is not None:
        overridden = {
            k: v
            for k, v, default in (
                ("b", b, None), ("nb", nb, None), ("method", method, "two_stage"),
                ("chase", chase, "wavefront"), ("max_sweeps", max_sweeps, 16),
            )
            if v != default
        }
        if overridden:
            raise ValueError(
                f"pass solver options via config=EvdConfig(...), not alongside it: {overridden}"
            )
        return config
    return EvdConfig(method=method, chase=chase, b=b, nb=nb, max_sweeps=max_sweeps)


def eigh(
    A: torch.Tensor,
    *,
    config=None,
    b: Optional[int] = None,
    nb: Optional[int] = None,
    method: str = "two_stage",
    chase: str = "wavefront",
    eigenvectors: bool = True,
    max_sweeps: int = 16,
):
    """Full symmetric eigendecomposition of one matrix, eigenvalues
    ascending: ``w`` or ``(w, V)`` with ``A @ V ≈ V @ diag(w)``."""
    from repro_torch.solver import plan_for

    cfg = _as_config(config, b=b, nb=nb, method=method, chase=chase, max_sweeps=max_sweeps)
    return plan_for(A, cfg)(A, eigenvectors=eigenvectors)


def eigvalsh(A: torch.Tensor, **kw) -> torch.Tensor:
    return eigh(A, eigenvectors=False, **kw)


def eigh_batched(
    A: torch.Tensor,
    *,
    config=None,
    eigenvectors: bool = True,
    b: Optional[int] = None,
    nb: Optional[int] = None,
    method: str = "two_stage",
    chase: str = "wavefront",
    max_sweeps: int = 16,
):
    """eigh over a batch (..., n, n) through ``solve_many``: one batch plan
    for the whole stack.  ``(w, V)``, or ``w`` without eigenvectors."""
    from repro_torch.solver import solve_many

    cfg = _as_config(config, b=b, nb=nb, method=method, chase=chase, max_sweeps=max_sweeps)
    return solve_many(A, cfg, eigenvectors=eigenvectors)


def eigvalsh_batched(A: torch.Tensor, **kw) -> torch.Tensor:
    """Eigenvalues-only batched solve over (..., n, n)."""
    return eigh_batched(A, eigenvectors=False, **kw)


def inverse_pth_root(
    A: torch.Tensor,
    p: int,
    *,
    eps: float = 1e-6,
    config=None,
    method: str = "two_stage",
    b: Optional[int] = None,
    nb: Optional[int] = None,
) -> torch.Tensor:
    """A^{-1/p} for symmetric PSD ``A`` (the Shampoo preconditioner), the
    eigenvalues ridged by ``eps * max(w)`` before the root."""
    from repro_torch.solver import plan_for

    cfg = _as_config(config, b=b, nb=nb, method=method)
    return plan_for(A, cfg).inverse_pth_root(A, p, eps=eps)
