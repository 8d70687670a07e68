"""Launcher of kernel C, ``csrc/backtransform.cu`` (the blocked Q2 apply).

Replaces ``repro.kernels.backtransform.backtransform_wy_pallas`` and its
wrapper ``repro.kernels.ops.backtransform_wy`` (minus the fallback).  A
bucket (X (B, n, m) with its logs (B, S, K, b)) is one call, as
``jax.vmap`` makes the Pallas kernel one call.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_lib
from .limits import grid_rows, limit

__all__ = ["backtransform_wy_cuda", "strip_width", "MAX_B"]

MAX_B = 32

_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, ctypes.c_int, _P]
_WORKSPACE_ARGTYPES = [ctypes.c_int] * 4
_MAX_STRIP = 32


def _lib():
    lib = cuda_lib.library("backtransform")
    fn = lib.backtransform_wy_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    ws = lib.backtransform_wy_workspace
    ws.argtypes = _WORKSPACE_ARGTYPES
    ws.restype = ctypes.c_longlong
    return fn, ws


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
    (S, K, b) / ``taus`` (S, K), ``b <= 32``; or a bucket, X (B, n, m) with
    vs (B, S, K, b) and taus (B, S, K), in one call.  ``group`` is accepted
    for the op's signature: the kernel blocks the sweeps by its own fixed
    group (``kGroup`` in ``csrc/backtransform.cu``).  Returns a new tensor
    of X's shape."""
    for name, t in (("X", X), ("vs", vs), ("taus", taus)):
        if not t.is_cuda:
            raise ValueError(f"backtransform_wy_cuda needs CUDA tensors, {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"backtransform_wy_cuda takes float32, {name} is {t.dtype}")
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
    lead = tuple(X.shape[:-2])
    if (X.ndim not in (2, 3) or vs.ndim != X.ndim + 1 or tuple(vs.shape[:-3]) != lead
            or taus.shape != vs.shape[:-1] or vs.shape[-1] != b):
        raise ValueError(
            f"expected X ([B,] n, m), vs ([B,] S, K, b={b}), taus ([B,] S, K); got {tuple(X.shape)}, "
            f"{tuple(vs.shape)}, {tuple(taus.shape)}"
        )
    if not 1 <= b <= MAX_B:
        raise ValueError(f"backtransform_wy_cuda takes 1 <= b <= {MAX_B}, got b={b}")
    batch = X.shape[0] if lead else 1
    if not 1 <= batch <= grid_rows():
        raise ValueError(f"a call takes 1 to {grid_rows()} matrices, got {batch}")
    n, m = X.shape[-2:]
    S, K, _ = vs.shape[-3:]
    out = torch.empty(X.shape, dtype=torch.float32, device=X.device)
    out.copy_(X)
    vs = vs.contiguous()
    taus = taus.contiguous()
    cw, in_smem = strip_width(n, m)
    fn, ws = _lib()
    work = torch.empty((max(batch * ws(n, S, K, b), 1),), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        err = fn(
            out.data_ptr(), n, m, vs.data_ptr(), taus.data_ptr(), S, K, b,
            int(transpose), cw, int(in_smem), work.data_ptr(), batch,
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, "backtransform_wy")
    cuda_lib.count("backtransform_wy", 2)
    return out
