"""Kernel registry: one dispatch point from hot op to implementation.

Op names are the JAX package's (``repro.backend.registry.OPS``).  Each op
has two backends:

* ``"torch"`` — the plain PyTorch version (eager tensor code; runs on any
  device and is the CPU path the parity tests hold against JAX);
* ``"cuda"``  — the hand-written Hopper kernel (``repro_torch.kernels``).
  It takes CUDA tensors only and raises on anything else.

There is no fallback between them.  A plan resolves its backend once
(``EvdConfig.backend``, else the ``REPRO_TORCH_KERNEL_BACKEND`` env var,
else ``"cuda"`` on a CUDA device and ``"torch"`` on the CPU), and an
explicit ``"torch"`` on a CUDA device is an opt-in pin.

This slice registers ``fused_panel_update``, ``bulge_wavefront`` and
``backtransform_wy``; the other ops raise ``NotImplementedError`` that
names the ROADMAP item that ports them.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import torch

__all__ = [
    "ENV_VAR",
    "BACKENDS",
    "OPS",
    "default_backend",
    "validate_backend",
    "resolve",
]

ENV_VAR = "REPRO_TORCH_KERNEL_BACKEND"
BACKENDS = ("torch", "cuda")
OPS = (
    "trailing_update",
    "syr2k",
    "fused_panel_update",
    "bulge_chase",
    "bulge_wavefront",
    "panel_qr",
    "backtransform_wy",
)
_LATER = {
    "trailing_update": "ROADMAP Queue 2 item 4 (syr2k)",
    "syr2k": "ROADMAP Queue 2 item 4 (syr2k)",
    "bulge_chase": "ROADMAP Queue 1 item 4 (tridiag='unfused')",
    "panel_qr": "ROADMAP Queue 2 item 5 (standalone panel QR)",
}

_IMPLS: Dict[Tuple[str, str], Callable] = {}


def validate_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; expected one of {BACKENDS}")
    return backend


def default_backend(device: torch.device) -> str:
    """The backend a plan on ``device`` uses when its config names none."""
    env = os.environ.get(ENV_VAR)
    if env:
        return validate_backend(env)
    return "cuda" if device.type == "cuda" else "torch"


def _build_impls() -> None:
    from repro_torch.core.backtransform import backtransform_wy_xla
    from repro_torch.core.bulge_chasing import chase_wavefront_slices
    from repro_torch.kernels import ops, ref

    def torch_bulge_wavefront(B, b, *, return_log=False):
        return chase_wavefront_slices(B, b, return_log)

    _IMPLS.update({
        ("fused_panel_update", "torch"): ref.fused_panel_update_ref,
        ("bulge_wavefront", "torch"): torch_bulge_wavefront,
        ("backtransform_wy", "torch"): backtransform_wy_xla,
        ("fused_panel_update", "cuda"): ops.fused_panel_update_cuda,
        ("bulge_wavefront", "cuda"): ops.bulge_wavefront_cuda,
        ("backtransform_wy", "cuda"): ops.backtransform_wy_cuda,
    })


def resolve(op: str, backend: str) -> Callable:
    """The implementation of ``op`` on ``backend``."""
    if op not in OPS:
        raise KeyError(f"unknown op {op!r}; expected one of {OPS}")
    validate_backend(backend)
    if op in _LATER:
        raise NotImplementedError(f"op {op!r} is not ported yet: {_LATER[op]}")
    if not _IMPLS:
        _build_impls()
    return _IMPLS[(op, backend)]
