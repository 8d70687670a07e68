"""Plain PyTorch versions of the hand-written kernels' block-level ops.

Each is the transparent version of its kernel: the CPU path, and what
``chip_smoke.py`` and the ``cuda``-marked tests hold the kernel against on
the card.  Port of the matching ``repro.kernels.ref`` oracles.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["syr2k_ref", "trailing_update_ref", "fused_panel_update_ref"]


def syr2k_ref(
    A: torch.Tensor, B: torch.Tensor, C: Optional[torch.Tensor] = None, *, alpha: float = 1.0
) -> torch.Tensor:
    """C + alpha (A B^T + B A^T), exactly symmetric: the lower triangle and
    its mirror, as ``repro.kernels.ops.syr2k`` assembles the lower-tile
    kernel's output (``tril(low) + tril(low, -1).T``).  ``C`` absent is
    zeros.  The plain version of kernel D (``csrc/syr2k.cu``)."""
    S = alpha * (A @ B.T + B @ A.T)
    if C is not None:
        S = C + S
    return torch.tril(S) + torch.tril(S, -1).T


def trailing_update_ref(C: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """The DBR trailing update: C - Z Y^T - Y Z^T."""
    return C - Z @ Y.T - Y @ Z.T


def fused_panel_update_ref(Bv: torch.Tensor, b: int, w: int):
    """Plain ``fused_panel_update``: the geqrf panel QRs plus the trailing
    update of ``repro_torch.core.band_reduction._reduce_block``.

    Like the kernel, it updates the trailing view ``Bv`` in place and
    returns ``(Bv, Vbuf (m, w), Ts (w//b, b, b))``.
    """
    from repro_torch.core.band_reduction import _reduce_block
    from repro_torch.core.panel_qr import panel_qr_geqrf

    new_view, Vbuf, Ts = _reduce_block(Bv, b, w, panel_qr_geqrf, trailing_update_ref)
    Bv.copy_(new_view)
    return Bv, Vbuf, Ts
