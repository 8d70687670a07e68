"""Launcher of kernel D, ``csrc/syr2k.cu`` (the lower-tile SYR2K).

Replaces ``repro.kernels.syr2k.syr2k_lower_pallas`` together with its
wrappers ``repro.kernels.ops.syr2k`` / ``ops.trailing_update`` (minus the
padding: the kernel masks ragged edges).  The two launchers share one
kernel and count under their own op names.  A bucket (operands with a
leading dimension B) is one call, as ``jax.vmap`` makes the Pallas kernel
one call.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_lib
from .limits import grid_rows

__all__ = ["syr2k_cuda", "trailing_update_cuda"]

_P = ctypes.c_void_p
_ARGTYPES = [_P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
             _P, ctypes.c_longlong, ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_int, _P]
DTYPES = (torch.float32, torch.bfloat16)


def _lib():
    fn = cuda_lib.library("syr2k").syr2k_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _row_major(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 and t.stride(-2) >= t.shape[-1] else t.contiguous()


def _launch(A, B, C, alpha: float, op: str) -> torch.Tensor:
    named = (("A", A), ("B", B)) + ((("C", C),) if C is not None else ())
    for name, t in named:
        if not t.is_cuda:
            raise ValueError(f"{op}_cuda needs CUDA tensors, {name} is on {t.device}")
        if t.dtype not in DTYPES:
            raise ValueError(f"{op}_cuda takes float32 or bfloat16, {name} is {t.dtype}")
        if t.dtype != A.dtype:
            raise ValueError(f"{name} is {t.dtype}, A is {A.dtype}: the operands share one dtype")
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")
    if A.ndim not in (2, 3) or B.shape != A.shape:
        raise ValueError(f"expected A, B of one ([B,] n, k) shape, got {tuple(A.shape)}, {tuple(B.shape)}")
    lead = tuple(A.shape[:-2])
    n, k = A.shape[-2:]
    if C is not None and tuple(C.shape) != lead + (n, n):
        raise ValueError(f"expected C of shape {lead + (n, n)}, got {tuple(C.shape)}")
    batch = A.shape[0] if lead else 1
    if not 1 <= batch <= grid_rows():
        raise ValueError(f"a call takes 1 to {grid_rows()} matrices, got {batch}")
    out = torch.empty(lead + (n, n), dtype=A.dtype, device=A.device)
    if n == 0:
        return out
    A = A.contiguous()
    B = B.contiguous()
    if C is not None:
        C = _row_major(C)
    fn = _lib()
    with torch.cuda.device(A.device):
        err = fn(
            A.data_ptr(), B.data_ptr(), k, n * k, n, k, float(alpha),
            None if C is None else C.data_ptr(), 0 if C is None else C.stride(-2),
            C.stride(0) if C is not None and lead else 0,
            out.data_ptr(), int(A.dtype == torch.bfloat16), batch, torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, op)
    cuda_lib.count(op, 1)
    return out


def syr2k_cuda(
    A: torch.Tensor, B: torch.Tensor, C: Optional[torch.Tensor] = None, *, alpha: float = 1.0
) -> torch.Tensor:
    """Kernel D: ``C + alpha (A B^T + B A^T)`` for CUDA ``A``, ``B`` (n, k)
    and ``C`` (n, n) or ``None`` (zeros), or a bucket of them (a leading
    dimension B on each), all float32 or all bfloat16 (summed
    in float32, rounded once to bfloat16).  Returns a new (n, n) tensor of
    their dtype, exactly symmetric: C's lower triangle updated and mirrored."""
    return _launch(A, B, C, alpha, "syr2k")


def trailing_update_cuda(C: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Kernel D as the DBR trailing update ``C - Z Y^T - Y Z^T``.  ``C`` may
    be a strided view with unit column stride (it is read, not written)."""
    return _launch(Z, Y, C, -1.0, "trailing_update")
