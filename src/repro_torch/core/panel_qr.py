"""Panel QR in compact-WY form, LAPACK sign convention.

``panel_qr_geqrf`` factors a tall (m, b) panel as ``Q [R; 0]`` with
``Q = I - V T V^T``: ``torch.geqrf`` (LAPACK / cuSOLVER) for the columns,
then ``larft`` for T.  Port of ``repro.core.panel_qr.panel_qr_geqrf``; it
is the panel factor of the plain ``fused_panel_update``.
"""
from __future__ import annotations

import torch

from .householder import larft

__all__ = ["panel_qr_geqrf"]


def panel_qr_geqrf(panel: torch.Tensor):
    """QR of a (m, b) panel.  Returns ``(V, T, taus, R)``."""
    m, b = panel.shape
    a_fact, taus = torch.geqrf(panel)
    rows = torch.arange(m, device=panel.device)[:, None]
    cols = torch.arange(b, device=panel.device)[None, :]
    R = torch.where(rows <= cols, a_fact, 0.0)[:b, :]
    V = torch.where(rows > cols, a_fact, 0.0)
    V = torch.where(rows == cols, 1.0, V)
    return V, larft(V, taus), taus, R
