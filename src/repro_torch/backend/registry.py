"""Kernel registry: one dispatch point from hot op to implementation.

Op names are the JAX package's (``repro.backend.registry.OPS``).  Each op
has two backends:

* ``"torch"`` — the plain PyTorch version (eager tensor code; runs on any
  device and is the CPU path the parity tests hold against JAX);
* ``"cuda"``  — the hand-written Hopper kernel, through its ``repro_torch``
  operator (``repro_torch.kernels.library``: a fake implementation and a
  work formula beside the launcher).  It takes CUDA tensors only and
  raises on anything else.

There is no fallback between them.  A plan resolves its backend once
(``EvdConfig.backend``, else the ``REPRO_TORCH_KERNEL_BACKEND`` env var,
else ``"cuda"`` on a CUDA device and ``"torch"`` on the CPU), and an
explicit ``"torch"`` on a CUDA device is an opt-in pin.  The first-stage
generation resolves the same way (:func:`default_tridiag`, the
``REPRO_TORCH_TRIDIAG`` env var, else ``"fused"``); both are part of the
plan-cache key.  The JAX package's switches (``REPRO_KERNEL_BACKEND``,
``REPRO_TRIDIAG``) are not read.

Every op is registered on both backends.  Where the port pairs differently
from the JAX registry: JAX's jnp ``panel_qr`` is ``panel_qr_geqrf`` (LAPACK
signs) beside a Pallas kernel with beta = +|x|, the two equal only up to
column signs.  Here the plain ``panel_qr`` is ``panel_qr_body(...,
lapack_sign=False)``, the very recurrence kernel E runs, so the kernel is
held to its plain version entry by entry (V, T, taus and R).  The plain
``syr2k`` / ``trailing_update`` mirror their lower triangle, as kernel D
and JAX's ``ops.syr2k`` do, so both backends are exactly symmetric.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

import torch

__all__ = [
    "ENV_VAR",
    "TRIDIAG_ENV_VAR",
    "BACKENDS",
    "TRIDIAGS",
    "OPS",
    "default_backend",
    "default_tridiag",
    "validate_backend",
    "resolve",
]

ENV_VAR = "REPRO_TORCH_KERNEL_BACKEND"
TRIDIAG_ENV_VAR = "REPRO_TORCH_TRIDIAG"
BACKENDS = ("torch", "cuda")
TRIDIAGS = ("fused", "unfused")
OPS = (
    "trailing_update",
    "syr2k",
    "fused_panel_update",
    "bulge_chase",
    "bulge_wavefront",
    "panel_qr",
    "backtransform_wy",
)

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


def default_tridiag() -> str:
    """The process-wide first-stage generation: ``"fused"`` unless
    ``REPRO_TORCH_TRIDIAG=unfused`` pins the legacy composition."""
    env = os.environ.get(TRIDIAG_ENV_VAR)
    if not env:
        return "fused"
    if env not in TRIDIAGS:
        raise ValueError(f"invalid {TRIDIAG_ENV_VAR}={env!r}; expected one of {TRIDIAGS}")
    return env


def _build_impls() -> None:
    from repro_torch.core.backtransform import backtransform_wy_xla
    from repro_torch.core.bulge_chasing import chase_wavefront, chase_wavefront_slices
    from repro_torch.kernels import library, ref
    from repro_torch.kernels.panel import panel_qr_body

    def torch_trailing_update(C, Y, Z):
        return ref.syr2k_ref(Z, Y, C, alpha=-1.0)

    def torch_bulge_chase(B, b):
        return chase_wavefront(B, b)

    def torch_bulge_wavefront(B, b, *, return_log=False):
        return chase_wavefront_slices(B, b, return_log)

    def torch_panel_qr(panel):
        return panel_qr_body(panel, panel.shape[1], lapack_sign=False)

    _IMPLS.update({
        ("trailing_update", "torch"): torch_trailing_update,
        ("syr2k", "torch"): ref.syr2k_ref,
        ("fused_panel_update", "torch"): ref.fused_panel_update_ref,
        ("bulge_chase", "torch"): torch_bulge_chase,
        ("bulge_wavefront", "torch"): torch_bulge_wavefront,
        ("panel_qr", "torch"): torch_panel_qr,
        ("backtransform_wy", "torch"): backtransform_wy_xla,
        ("trailing_update", "cuda"): library.trailing_update,
        ("syr2k", "cuda"): library.syr2k,
        ("fused_panel_update", "cuda"): library.fused_panel_update,
        ("bulge_chase", "cuda"): library.bulge_chase,
        ("bulge_wavefront", "cuda"): library.bulge_wavefront,
        ("panel_qr", "cuda"): library.panel_qr,
        ("backtransform_wy", "cuda"): library.backtransform_wy,
    })


def resolve(op: str, backend: str) -> Callable:
    """The implementation of ``op`` on ``backend``."""
    if op not in OPS:
        raise KeyError(f"unknown op {op!r}; expected one of {OPS}")
    validate_backend(backend)
    if not _IMPLS:
        _build_impls()
    return _IMPLS[(op, backend)]
