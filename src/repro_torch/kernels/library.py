"""Kernels A–E as operators of the ``repro_torch`` namespace.

Each launcher (``fused_panel.py``, ``bulge.py``, ``backtransform.py``,
``syr2k.py``, ``panel.py``) is the CUDA implementation of one operator,
``torch.ops.repro_torch.<name>``, defined with ``torch.library.Library``
(``define`` and ``impl(..., "CUDA")``: the dispatcher's own route, lighter
per call than ``torch.library.custom_op``).  Each operator also has

* a fake implementation (``register_fake``): its outputs' shapes, dtypes
  and strides from the input shapes, with no work, so the refresh runs on
  ``FakeTensorMode`` tensors (the dry-run);
* a bucket form (kernels A–D): the inputs may carry a leading dimension
  B, and one call then runs the kernel on every matrix of the bucket, as
  ``jax.vmap``'s batching rule gives the Pallas kernel a leading grid axis;
* a work formula registered with ``torch.utils.flop_counter``
  (``kernels/work.py``), so ``FlopCounterMode`` and
  ``repro_torch.analysis`` count the FLOPs of the kernel's function,
  whatever implements it.

Operators do not return their inputs: kernel A updates its trailing view in
place (declared ``Tensor(a!)``) and returns ``(V, Ts)``; kernel B is two
operators, ``bulge_wavefront`` (with the log) and ``bulge_chase`` (T
alone), as kernel D is ``syr2k`` and ``trailing_update``.  The functions
below restore the launchers' return values (``(Bv, V, Ts)``, a
``ChaseLog``).  No operator has a CPU implementation: a CPU tensor raises
(``NotImplementedError`` from the dispatcher).  Launches are counted where
they always were, inside the launchers, so a fake call counts nothing.
"""
from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.backend.trace import NAMESPACE

from . import work
from .backtransform import backtransform_wy_cuda
from .bulge import bulge_wavefront_cuda
from .fused_panel import fused_panel_update_cuda
from .panel import panel_qr_cuda
from .syr2k import syr2k_cuda, trailing_update_cuda

__all__ = [
    "NAMESPACE",
    "OPERATORS",
    "fused_panel_update",
    "bulge_wavefront",
    "bulge_chase",
    "backtransform_wy",
    "syr2k",
    "trailing_update",
    "panel_qr",
]

_lib = torch.library.Library(NAMESPACE, "DEF")


def _cuda_fused_panel_update(Bv, b, w):
    _, V, Ts = fused_panel_update_cuda(Bv, b, w)
    return V, Ts


def _lead(t):
    """A call's leading (bucket) dimensions: () for one matrix, (B,)."""
    return tuple(t.shape[:-2])


def _batch(shape) -> int:
    """Matrices of a call, from an input's shape as the FLOP counter passes it."""
    return math.prod(shape[:-2])


def _fake_fused_panel_update(Bv, b, w):
    m = Bv.shape[-1]
    return Bv.new_empty(_lead(Bv) + (m, w)), Bv.new_empty(_lead(Bv) + (w // b, b, b))


def _cuda_bulge_wavefront(B, b):
    T, log = bulge_wavefront_cuda(B, b, return_log=True)
    return T, log.vs, log.taus, log.row0


def _log_shape(n: int, b: int):
    """(W, A, b) of kernel B's log (one slot, b >= 1, where no chase op exists)."""
    if n < 3 or b <= 1:
        return 1, None, max(b, 1)
    return 3 * (n - 3) + 1, ((n - 3) // b + 3) // 3 + 1, b


def _fake_bulge_wavefront(B, b):
    n = B.shape[-1]
    W, A, bb = _log_shape(n, b)
    lead = _lead(B) + ((W,) if A is None else (W, A))
    return (B.new_empty(B.shape), B.new_empty(lead + (bb,)), B.new_empty(lead),
            B.new_empty(lead, dtype=torch.int32))


def _cuda_bulge_chase(B, b):
    return bulge_wavefront_cuda(B, b)


def _fake_bulge_chase(B, b):
    return B.new_empty(B.shape)


def _cuda_backtransform_wy(X, vs, taus, b, transpose):
    return backtransform_wy_cuda(X, vs, taus, b=b, transpose=transpose)


def _fake_backtransform_wy(X, vs, taus, b, transpose):
    return X.new_empty(X.shape)


def _cuda_syr2k(A, B, C, alpha):
    return syr2k_cuda(A, B, C, alpha=alpha)


def _fake_syr2k(A, B, C, alpha):
    n = A.shape[-2]
    return A.new_empty(_lead(A) + (n, n))


def _fake_trailing_update(C, Y, Z):
    n = Z.shape[-2]
    return Z.new_empty(_lead(Z) + (n, n))


def _fake_panel_qr(panel):
    m, b = panel.shape
    return panel.new_empty((m, b)), panel.new_empty((b, b)), panel.new_empty((b,)), panel.new_empty((b, b))


def _flops(w: work.Work) -> int:
    return int(round(w.total_flops))


# operator -> (schema, CUDA implementation, fake implementation, FLOPs from
# input shapes, as ``torch.utils.flop_counter`` passes them).  Kernels A–D
# take one matrix or a bucket (a leading dimension B): B times the work.
_OPS = {
    "fused_panel_update": ("fused_panel_update(Tensor(a!) Bv, int b, int w) -> (Tensor, Tensor)",
                           _cuda_fused_panel_update, _fake_fused_panel_update,
                           lambda Bv, b, w, out_shape=None: _flops(
                               work.fused_panel_update(Bv[-1], w, b, batch=_batch(Bv)))),
    "bulge_wavefront": ("bulge_wavefront(Tensor B, int b) -> (Tensor, Tensor, Tensor, Tensor)",
                        _cuda_bulge_wavefront, _fake_bulge_wavefront,
                        lambda B, b, out_shape=None: _flops(work.bulge_wavefront(B[-1], b, batch=_batch(B)))),
    "bulge_chase": ("bulge_chase(Tensor B, int b) -> Tensor", _cuda_bulge_chase, _fake_bulge_chase,
                    lambda B, b, out_shape=None: _flops(work.bulge_wavefront(B[-1], b, log=False, batch=_batch(B)))),
    "backtransform_wy": ("backtransform_wy(Tensor X, Tensor vs, Tensor taus, int b, bool transpose) -> Tensor",
                         _cuda_backtransform_wy, _fake_backtransform_wy,
                         lambda X, vs, taus, b, transpose, out_shape=None: _flops(
                             work.backtransform_wy(X[-2], X[-1], vs[-3], vs[-2], b, batch=_batch(X)))),
    "syr2k": ("syr2k(Tensor A, Tensor B, Tensor? C, float alpha) -> Tensor", _cuda_syr2k, _fake_syr2k,
              lambda A, B, C, alpha, out_shape=None: _flops(
                  work.syr2k(A[-2], A[-1], with_c=C is not None, batch=_batch(A)))),
    "trailing_update": ("trailing_update(Tensor C, Tensor Y, Tensor Z) -> Tensor", trailing_update_cuda,
                        _fake_trailing_update,
                        lambda C, Y, Z, out_shape=None: _flops(work.syr2k(Z[-2], Z[-1], batch=_batch(Z)))),
    "panel_qr": ("panel_qr(Tensor panel) -> (Tensor, Tensor, Tensor, Tensor)", panel_qr_cuda, _fake_panel_qr,
                 lambda panel, out_shape=None: _flops(work.panel_qr(panel[0], panel[1]))),
}
OPERATORS = tuple(_OPS)

for _name, (_schema, _cuda, _fake, _formula) in _OPS.items():
    _lib.define(_schema)
    _lib.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_lib)
    register_flop_formula(getattr(torch.ops.repro_torch, _name))(_formula)

_ops = torch.ops.repro_torch


def fused_panel_update(Bv: torch.Tensor, b: int, w: int):
    """Kernel A: ``(Bv, V, Ts)``, ``Bv`` updated in place."""
    V, Ts = _ops.fused_panel_update(Bv, b, w)
    return Bv, V, Ts


def bulge_wavefront(B: torch.Tensor, b: int, *, return_log: bool = False):
    """Kernel B: ``T`` or ``(T, ChaseLog)``."""
    if not return_log:
        return _ops.bulge_chase(B, b)
    from repro_torch.core.bulge_chasing import ChaseLog

    T, vs, taus, row0 = _ops.bulge_wavefront(B, b)
    return T, ChaseLog(vs=vs, taus=taus, row0=row0, n=B.shape[-1], b=vs.shape[-1])


def bulge_chase(B: torch.Tensor, b: int) -> torch.Tensor:
    """Kernel B without the log."""
    return _ops.bulge_chase(B, b)


def backtransform_wy(X, vs, taus, *, b: int, group=None, transpose: bool = False) -> torch.Tensor:
    """Kernel C: Q2 @ X (or Q2^T @ X); ``group`` is the op's signature's
    (the kernel blocks the sweeps by its own fixed group)."""
    return _ops.backtransform_wy(X, vs, taus, b, transpose)


def syr2k(A: torch.Tensor, B: torch.Tensor, C=None, *, alpha: float = 1.0) -> torch.Tensor:
    """Kernel D: ``C + alpha (A B^T + B A^T)``."""
    return _ops.syr2k(A, B, C, float(alpha))


def trailing_update(C: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Kernel D as ``C - Z Y^T - Y Z^T``."""
    return _ops.trailing_update(C, Y, Z)


def panel_qr(panel: torch.Tensor):
    """Kernel E: ``(V, T, taus, R)``."""
    return _ops.panel_qr(panel)
