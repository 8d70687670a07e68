"""Device-dispatching wrappers of the port's kernels.

A CUDA tensor goes to the hand-written kernel through its ``repro_torch``
operator (``kernels/library.py``; it launches or raises); a CPU tensor
goes to the plain PyTorch version.  Nothing else decides: no
size ceiling, no ``try``, no environment default.  The registry
(``repro_torch.backend.registry``) resolves the same two implementations
by backend name.
"""
from __future__ import annotations

import torch

from . import library
from .panel import panel_qr_body

__all__ = [
    "syr2k",
    "trailing_update",
    "fused_panel_update",
    "bulge_chase",
    "bulge_wavefront",
    "panel_qr",
    "backtransform_wy",
]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def syr2k(A: torch.Tensor, B: torch.Tensor, C=None, *, alpha: float = 1.0) -> torch.Tensor:
    """Symmetric ``C + alpha (A B^T + B A^T)`` (``C`` absent: zeros)."""
    if _on_cuda(A):
        return library.syr2k(A, B, C, alpha=alpha)
    from .ref import syr2k_ref

    return syr2k_ref(A, B, C, alpha=alpha)


def trailing_update(C: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """The DBR trailing update ``C - Z Y^T - Y Z^T`` (syr2k, alpha = -1)."""
    if _on_cuda(C):
        return library.trailing_update(C, Y, Z)
    from .ref import syr2k_ref

    return syr2k_ref(Z, Y, C, alpha=-1.0)


def panel_qr(panel: torch.Tensor):
    """Householder QR (beta = +|x|) of an (m, b) panel: ``(V, T, taus, R)``."""
    if _on_cuda(panel):
        return library.panel_qr(panel)
    return panel_qr_body(panel, panel.shape[1], lapack_sign=False)


def fused_panel_update(Bv: torch.Tensor, b: int, w: int):
    """One DBR block step on the trailing view ``Bv``, in place."""
    if _on_cuda(Bv):
        return library.fused_panel_update(Bv, b, w)
    from .ref import fused_panel_update_ref

    return fused_panel_update_ref(Bv, b, w)


def bulge_wavefront(B: torch.Tensor, b: int, *, return_log: bool = False):
    """Band -> tridiagonal, optionally with the (W, A, b) reflector log."""
    if _on_cuda(B):
        return library.bulge_wavefront(B, b, return_log=return_log)
    from repro_torch.core.bulge_chasing import chase_wavefront_slices

    return chase_wavefront_slices(B, b, return_log)


def bulge_chase(B: torch.Tensor, b: int) -> torch.Tensor:
    """Band -> tridiagonal without the log (kernel B, as JAX's
    ``ops.bulge_chase`` runs ``bulge_wavefront_pallas`` without it)."""
    if _on_cuda(B):
        return library.bulge_chase(B, b)
    from repro_torch.core.bulge_chasing import chase_wavefront

    return chase_wavefront(B, b)


def backtransform_wy(X, vs, taus, *, b: int, group=None, transpose: bool = False):
    """Q2 @ X (or Q2^T @ X) from the sweep-major log."""
    if _on_cuda(X):
        return library.backtransform_wy(X, vs, taus, b=b, group=group, transpose=transpose)
    from repro_torch.core.backtransform import backtransform_wy_xla

    return backtransform_wy_xla(X, vs, taus, b=b, group=group, transpose=transpose)
