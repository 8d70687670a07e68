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

__all__ = ["fused_panel_update_cuda", "MAX_B"]

MAX_B = 32
_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int, _P]


def _lib():
    lib = cuda_lib.library("fused_panel")
    fn = lib.fused_panel_update_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


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
    kw = dict(dtype=torch.float32, device=Bv.device)
    V = torch.empty((m, w), **kw)
    Ts = torch.empty((q, b, b), **kw)
    Z = torch.empty((m, w), **kw)
    F = torch.empty((m, w), **kw)
    P = torch.empty((m, b), **kw)
    Vh = torch.empty((m, b), **kw)
    MT = torch.empty((m, b), **kw)
    X = torch.empty((2 * w * b,), **kw)
    Y = torch.empty((b * b,), **kw)
    fn = _lib()
    with torch.cuda.device(Bv.device):
        err = fn(
            Bv.data_ptr(), Bv.stride(0), m, w, b,
            V.data_ptr(), Ts.data_ptr(), Z.data_ptr(), F.data_ptr(), P.data_ptr(),
            Vh.data_ptr(), MT.data_ptr(), X.data_ptr(), Y.data_ptr(),
            limit("PANEL_QR_SMEM"), torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, "fused_panel_update")
    cuda_lib.count("fused_panel_update", 5 * q + 1)
    return Bv, V, Ts
