"""Device-dispatching wrappers of the three kernels of this slice.

A CUDA tensor goes to the hand-written kernel (which launches or raises);
a CPU tensor goes to the plain PyTorch version.  Nothing else decides: no
size ceiling, no ``try``, no environment default.  The registry
(``repro_torch.backend.registry``) resolves the same two implementations
by backend name.
"""
from __future__ import annotations

import torch

from .backtransform import backtransform_wy_cuda
from .bulge import bulge_wavefront_cuda
from .fused_panel import fused_panel_update_cuda

__all__ = [
    "fused_panel_update",
    "bulge_wavefront",
    "backtransform_wy",
    "fused_panel_update_cuda",
    "bulge_wavefront_cuda",
    "backtransform_wy_cuda",
]


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cuda"


def fused_panel_update(Bv: torch.Tensor, b: int, w: int):
    """One DBR block step on the trailing view ``Bv``, in place."""
    if _on_cuda(Bv):
        return fused_panel_update_cuda(Bv, b, w)
    from .ref import fused_panel_update_ref

    return fused_panel_update_ref(Bv, b, w)


def bulge_wavefront(B: torch.Tensor, b: int, *, return_log: bool = False):
    """Band -> tridiagonal, optionally with the (W, A, b) reflector log."""
    if _on_cuda(B):
        return bulge_wavefront_cuda(B, b, return_log=return_log)
    from repro_torch.core.bulge_chasing import chase_wavefront_slices

    return chase_wavefront_slices(B, b, return_log)


def backtransform_wy(X, vs, taus, *, b: int, group=None, transpose: bool = False):
    """Q2 @ X (or Q2^T @ X) from the sweep-major log."""
    if _on_cuda(X):
        return backtransform_wy_cuda(X, vs, taus, b=b, group=group, transpose=transpose)
    from repro_torch.core.backtransform import backtransform_wy_xla

    return backtransform_wy_xla(X, vs, taus, b=b, group=group, transpose=transpose)
