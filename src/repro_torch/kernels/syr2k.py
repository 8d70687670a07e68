"""Launcher of kernel D, ``csrc/syr2k.cu`` (the lower-tile SYR2K).

Replaces ``repro.kernels.syr2k.syr2k_lower_pallas`` together with its
wrappers ``repro.kernels.ops.syr2k`` / ``ops.trailing_update`` (minus the
padding: the kernel masks ragged edges).  The two launchers share one
kernel and count under their own op names.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_lib

__all__ = ["syr2k_cuda", "trailing_update_cuda"]

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             _P, ctypes.c_longlong, _P, _P]


def _lib():
    fn = cuda_lib.library("syr2k").syr2k_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _row_major(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(1) == 1 and t.stride(0) >= t.shape[1] else t.contiguous()


def _launch(A, B, C, alpha: float, op: str) -> torch.Tensor:
    named = (("A", A), ("B", B)) + ((("C", C),) if C is not None else ())
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{op}_cuda needs CUDA tensors, {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{op}_cuda takes float32, {name} is {t.dtype}")
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")
    if A.ndim != 2 or B.shape != A.shape:
        raise ValueError(f"expected A, B of one (n, k) shape, got {tuple(A.shape)}, {tuple(B.shape)}")
    n, k = A.shape
    if C is not None and tuple(C.shape) != (n, n):
        raise ValueError(f"expected C of shape ({n}, {n}), got {tuple(C.shape)}")
    out = torch.empty((n, n), dtype=torch.float32, device=A.device)
    if n == 0:
        return out
    A = A.contiguous()
    B = B.contiguous()
    if C is not None:
        C = _row_major(C)
    fn = _lib()
    with torch.cuda.device(A.device):
        err = fn(
            A.data_ptr(), B.data_ptr(), k, n, k, float(alpha),
            None if C is None else C.data_ptr(), 0 if C is None else C.stride(0),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, op)
    cuda_lib.count(op, 1)
    return out


def syr2k_cuda(
    A: torch.Tensor, B: torch.Tensor, C: Optional[torch.Tensor] = None, *, alpha: float = 1.0
) -> torch.Tensor:
    """Kernel D: ``C + alpha (A B^T + B A^T)`` for float32 CUDA ``A``, ``B``
    (n, k) and ``C`` (n, n) or ``None`` (zeros).  Returns a new (n, n)
    tensor, exactly symmetric: C's lower triangle updated and mirrored."""
    return _launch(A, B, C, alpha, "syr2k")


def trailing_update_cuda(C: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Kernel D as the DBR trailing update ``C - Z Y^T - Y Z^T``.  ``C`` may
    be a strided view with unit column stride (it is read, not written)."""
    return _launch(Z, Y, C, -1.0, "trailing_update")
