"""Panel QR in compact-WY form.

Both functions factor a tall (m, b) panel as ``Q [R; 0]`` with
``Q = I - V T V^T`` and return ``(V, T, taus, R)``; ports of
``repro.core.panel_qr``:

* ``panel_qr_geqrf`` — ``torch.geqrf`` (LAPACK / cuSOLVER) for the
  columns, then ``larft`` for T; LAPACK signs.  It is the panel factor of
  the plain ``fused_panel_update`` and ``band_reduce``'s default.
* ``panel_qr_householder`` — b column steps of :func:`house`, beta = +|x|
  (the JAX package's historical sign); ``band_reduce(panel_method=
  "householder")``.

:func:`panel_qr` dispatches on ``method`` as ``band_reduce``'s
``panel_method`` does, ``"kernel"`` being the ``panel_qr`` registry op
(kernel E on ``cuda``; the JAX package names it ``"pallas"``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.backend import registry

from .householder import house, larft

__all__ = ["panel_qr", "panel_qr_geqrf", "panel_qr_householder"]


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


def panel_qr_householder(panel: torch.Tensor):
    """Column-by-column Householder QR of a (m, b) panel with :func:`house`
    (beta = +|x|).  Returns ``(V, T, taus, R)``."""
    m, b = panel.shape
    A = panel.clone()
    V = torch.zeros_like(A)
    taus = torch.zeros((b,), dtype=A.dtype, device=A.device)
    for j in range(b):
        v_tail, tau, beta = house(A[j:, j])
        # Apply H = I - tau v v^T to columns j.. of rows j..; column j is
        # then exactly (beta, 0, ..., 0).
        A[j:, j:] -= tau * torch.outer(v_tail, v_tail @ A[j:, j:])
        A[j, j] = beta
        A[j + 1 :, j] = 0.0
        V[j:, j] = v_tail
        taus[j] = tau
    return V, larft(V, taus), taus, A[:b, :].clone()


def resolve_panel_qr(method: str, backend: str) -> Callable:
    """The panel factor ``method`` names: ``"geqrf"``, ``"householder"`` or
    ``"kernel"`` (the ``panel_qr`` op on ``backend``)."""
    if method == "geqrf":
        return panel_qr_geqrf
    if method == "householder":
        return panel_qr_householder
    if method == "kernel":
        return registry.resolve("panel_qr", backend)
    raise ValueError(f"unknown panel_method {method!r}; expected 'geqrf', 'householder' or 'kernel'")


def panel_qr(panel: torch.Tensor, method: str = "geqrf", *, backend: Optional[str] = None):
    """QR of a (m, b) panel by ``method`` (see :func:`resolve_panel_qr`;
    ``backend`` defaults by the panel's device).  Returns
    ``(V, T, taus, R)``."""
    return resolve_panel_qr(method, backend or registry.default_backend(panel.device))(panel)
