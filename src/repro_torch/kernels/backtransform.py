"""Launcher of kernel C, ``csrc/backtransform.cu`` (the blocked Q2 apply).

Replaces ``repro.kernels.backtransform.backtransform_wy_pallas`` and its
wrapper ``repro.kernels.ops.backtransform_wy`` (minus the fallback).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_lib
from .limits import limit

__all__ = ["backtransform_wy_cuda", "strip_width"]

_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]
_MAX_STRIP = 32


def _lib():
    fn = cuda_lib.library("backtransform").backtransform_wy_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def strip_width(n: int, m: int):
    """(columns per CTA, strip in shared memory?) for an (n, m) panel: the
    widest strip of at most 32 columns whose (n, cw) block fits the
    ``BACKTRANSFORM_SMEM`` budget, else 32 columns in global memory."""
    cw = min(_MAX_STRIP, limit("BACKTRANSFORM_SMEM") // (4 * n), m)
    if cw >= 1:
        return cw, True
    return min(_MAX_STRIP, m), False


def backtransform_wy_cuda(
    X: torch.Tensor,
    vs: torch.Tensor,
    taus: torch.Tensor,
    *,
    b: int,
    group: Optional[int] = None,
    transpose: bool = False,
) -> torch.Tensor:
    """Kernel C: Q2 @ X (or Q2^T @ X) from the sweep-major log ``vs``
    (S, K, b) / ``taus`` (S, K).  ``group`` is accepted for the op's
    signature; the kernel applies each sweep's K reflectors in parallel, so
    it has no use for it.  Returns a new (n, m) tensor."""
    for name, t in (("X", X), ("vs", vs), ("taus", taus)):
        if not t.is_cuda:
            raise ValueError(f"backtransform_wy_cuda needs CUDA tensors, {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"backtransform_wy_cuda takes float32, {name} is {t.dtype}")
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
    if X.ndim != 2 or vs.ndim != 3 or taus.shape != vs.shape[:2] or vs.shape[2] != b:
        raise ValueError(
            f"expected X (n, m), vs (S, K, b={b}), taus (S, K); got {tuple(X.shape)}, "
            f"{tuple(vs.shape)}, {tuple(taus.shape)}"
        )
    n, m = X.shape
    S, K, _ = vs.shape
    out = torch.empty((n, m), dtype=torch.float32, device=X.device)
    out.copy_(X)
    vs = vs.contiguous()
    taus = taus.contiguous()
    cw, in_smem = strip_width(n, m)
    fn = _lib()
    with torch.cuda.device(X.device):
        err = fn(
            out.data_ptr(), n, m, vs.data_ptr(), taus.data_ptr(), S, K, b,
            int(transpose), cw, int(in_smem), torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, "backtransform_wy")
    cuda_lib.count("backtransform_wy", 1)
    return out
