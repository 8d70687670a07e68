"""Launcher of kernel A, ``csrc/fused_panel.cu`` (one fused DBR block step).

Replaces ``repro.kernels.fused_panel.fused_panel_update_pallas`` together
with its wrapper ``repro.kernels.ops.fused_panel_update`` (minus the
fallback: there is no size ceiling, and a shape the kernel cannot take
raises).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .limits import limit

__all__ = ["fused_panel_update_cuda", "cluster_size", "buffers", "MAX_B"]

MAX_B = 32
_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P]
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
    return fn, ws


def buffers(m: int, w: int, b: int, cluster: int, device, workspace) -> dict:
    """The buffers of one call, in the launcher's argument order after
    ``Bv``: V, Ts, Z, F, P, Vh, MT, X, Y, then the reductions' partials R
    and their tickets, sized by ``workspace`` (the library's
    ``fused_panel_update_workspace``)."""
    q = w // b
    kw = dict(dtype=torch.float32, device=device)
    ntickets = ctypes.c_int(0)
    r_floats = workspace(m, w, b, ctypes.byref(ntickets))
    return dict(
        V=torch.empty((m, w), **kw), Ts=torch.empty((q, b, b), **kw),
        Z=torch.empty((m, w), **kw), F=torch.empty((m, w), **kw),
        P=torch.empty((m + cluster, b), **kw), Vh=torch.empty((m, b), **kw),
        MT=torch.empty((m, b), **kw), X=torch.empty((2 * w * b,), **kw),
        Y=torch.empty((b * b,), **kw), R=torch.empty((r_floats,), **kw),
        tickets=torch.empty((ntickets.value,), dtype=torch.int32, device=device),
    )


def cluster_size(m: int, b: int) -> int:
    """CTAs of the panel QR's cluster for an (m, m) view: at least
    ``_ROWS_PER_CTA`` panel rows each, at most ``PANEL_QR_CLUSTER``."""
    return max(1, min(limit("PANEL_QR_CLUSTER"), -(-(m - b) // _ROWS_PER_CTA)))


def fused_panel_update_cuda(Bv: torch.Tensor, b: int, w: int):
    """Kernel A on the trailing view ``Bv`` (m, m), updated in place.

    ``Bv`` must be a float32 CUDA tensor with unit column stride (a view
    ``B[ci:, ci:]`` of a row-major matrix is fine).  Returns
    ``(Bv, V (m, w), Ts (w//b, b, b))``, the contract of the plain
    ``repro_torch.kernels.ref.fused_panel_update_ref``.
    """
    if not Bv.is_cuda:
        raise ValueError(f"fused_panel_update_cuda needs a CUDA tensor, got {Bv.device}")
    if Bv.dtype != torch.float32:
        raise ValueError(f"fused_panel_update_cuda takes float32, got {Bv.dtype}")
    if Bv.ndim != 2 or Bv.shape[0] != Bv.shape[1]:
        raise ValueError(f"expected a square trailing view, got {tuple(Bv.shape)}")
    m = Bv.shape[0]
    if Bv.stride(1) != 1 or Bv.stride(0) < m:
        raise ValueError(f"trailing view must be row-major with unit column stride, got strides {Bv.stride()}")
    if not (1 <= b <= MAX_B) or w % b != 0 or w < b or m - w < b:
        raise ValueError(f"need 1 <= b <= {MAX_B}, w % b == 0 and b <= m - w; got m={m} w={w} b={b}")
    q = w // b
    cluster = cluster_size(m, b)
    fn, workspace = _lib()
    buf = buffers(m, w, b, cluster, Bv.device, workspace)
    with torch.cuda.device(Bv.device):
        err = fn(
            Bv.data_ptr(), Bv.stride(0), m, w, b, *(t.data_ptr() for t in buf.values()),
            limit("PANEL_QR_SMEM"), cluster, torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, "fused_panel_update")
    cuda_lib.count("fused_panel_update", 4 * q + 1)
    return Bv, buf["V"], buf["Ts"]
