"""Launcher of kernel A, ``csrc/fused_panel.cu`` (one fused DBR block step).

Replaces ``repro.kernels.fused_panel.fused_panel_update_pallas`` together
with its wrapper ``repro.kernels.ops.fused_panel_update`` (minus the
fallback: there is no size ceiling, and a shape the kernel cannot take
raises).  A stack of views (B, m, m) is one call, as ``jax.vmap`` makes
the Pallas kernel one call with a leading grid axis.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.backend import trace

from . import cuda_lib
from .limits import grid_rows, limit

__all__ = ["fused_panel_update_cuda", "cluster_size", "buffers", "MAX_B"]

MAX_B = 32
_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P]
_WORKSPACE_ARGTYPES = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
_ROWS_PER_CTA = 64


def _lib():
    lib = cuda_lib.library("fused_panel")
    fn = lib.fused_panel_update_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    ws = lib.fused_panel_update_workspace
    ws.argtypes = _WORKSPACE_ARGTYPES
    ws.restype = ctypes.c_longlong
    rows = lib.fused_panel_gemv_rows
    rows.argtypes = [ctypes.c_int]
    rows.restype = ctypes.c_int
    return fn, ws, rows


def buffers(m: int, w: int, b: int, cluster: int, device, workspace, batch: int = 1) -> dict:
    """The buffers of one call on ``batch`` views, in the launcher's
    argument order after ``Bv``: V, Ts, Z, F, P, Vh, MT, X, Y, then the
    reductions' partials R and their tickets, sized by ``workspace`` (the
    library's ``fused_panel_update_workspace``); each holds one copy a
    matrix."""
    q = w // b
    kw = dict(dtype=torch.float32, device=device)
    ntickets = ctypes.c_int(0)
    r_floats = workspace(m, w, b, ctypes.byref(ntickets))
    B = (batch,)
    return dict(
        V=torch.empty(B + (m, w), **kw), Ts=torch.empty(B + (q, b, b), **kw),
        Z=torch.empty(B + (m, w), **kw), F=torch.empty(B + (m, w), **kw),
        P=torch.empty(B + (m + cluster, b), **kw), Vh=torch.empty(B + (m, b), **kw),
        MT=torch.empty(B + (m, b), **kw), X=torch.empty(B + (2 * w * b,), **kw),
        Y=torch.empty(B + (b * b,), **kw), R=torch.empty(B + (r_floats,), **kw),
        tickets=torch.empty(B + (ntickets.value,), dtype=torch.int32, device=device),
    )


def cluster_size(m: int, b: int) -> int:
    """CTAs of the panel QR's cluster for an (m, m) view: at least
    ``_ROWS_PER_CTA`` panel rows each, at most ``PANEL_QR_CLUSTER``."""
    return max(1, min(limit("PANEL_QR_CLUSTER"), -(-(m - b) // _ROWS_PER_CTA)))


def fused_panel_update_cuda(Bv: torch.Tensor, b: int, w: int):
    """Kernel A on the trailing view ``Bv`` (m, m), or on a bucket of views
    (B, m, m) in one call, updated in place.

    ``Bv`` must be a float32 CUDA tensor with unit column stride (a view
    ``B[..., ci:, ci:]`` of row-major matrices is fine), at most
    :func:`~repro_torch.kernels.limits.grid_rows` matrices, and symmetric
    bit for bit: the kernel's GEMV reads only the lower triangle of the
    rows it multiplies (a symmetric product) outside the row walk's range
    of m, where its panels are counted as ``kernel_a.gemv_rowwalk_panels``
    while tracing.  Every caller passes such a view: ``band_reduce`` (so
    ``plan``, ``solve_many`` and ``tridiagonalize``) reduces its input's
    lower triangle and that triangle's mirror, and the trailing view a call
    leaves (``Bv[..., w:, w:]``) is written with its mirror.  Returns
    ``(Bv, V (..., m, w), Ts (..., w//b, b, b))``, the contract of the plain
    ``repro_torch.kernels.ref.fused_panel_update_ref``.
    """
    if not Bv.is_cuda:
        raise ValueError(f"fused_panel_update_cuda needs a CUDA tensor, got {Bv.device}")
    if Bv.dtype != torch.float32:
        raise ValueError(f"fused_panel_update_cuda takes float32, got {Bv.dtype}")
    if Bv.ndim not in (2, 3) or Bv.shape[-1] != Bv.shape[-2]:
        raise ValueError(f"expected a square trailing view (m, m) or a bucket (B, m, m), got {tuple(Bv.shape)}")
    one = Bv.ndim == 2
    Bs = Bv[None] if one else Bv
    batch, m = Bs.shape[0], Bs.shape[-1]
    if Bs.stride(2) != 1 or Bs.stride(1) < m:
        raise ValueError(f"trailing view must be row-major with unit column stride, got strides {Bv.stride()}")
    if not (1 <= b <= MAX_B) or w % b != 0 or w < b or m - w < b:
        raise ValueError(f"need 1 <= b <= {MAX_B}, w % b == 0 and b <= m - w; got m={m} w={w} b={b}")
    if not 1 <= batch <= grid_rows():
        raise ValueError(f"a call takes 1 to {grid_rows()} matrices, got {batch}")
    q = w // b
    cluster = cluster_size(m, b)
    fn, workspace, gemv_rows = _lib()
    buf = buffers(m, w, b, cluster, Bv.device, workspace, batch)
    with torch.cuda.device(Bv.device):
        err = fn(
            Bs.data_ptr(), Bs.stride(1), Bs.stride(0), batch, m, w, b,
            *(t.data_ptr() for t in buf.values()),
            limit("PANEL_QR_SMEM"), cluster, torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, "fused_panel_update")
    cuda_lib.count("fused_panel_update", 4 * q + 1)
    if gemv_rows(m):
        trace.count("kernel_a.gemv_rowwalk_panels", q)
    if one:
        return Bv, buf["V"][0], buf["Ts"][0]
    return Bv, buf["V"], buf["Ts"]
