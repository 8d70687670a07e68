"""Launcher of kernel B, ``csrc/bulge.cu`` (the wavefront bulge chase).

Replaces ``repro.kernels.bulge.bulge_wavefront_pallas`` and its wrapper
``repro.kernels.ops.bulge_wavefront`` (minus the fallback).  The log comes
out in the plain version's (W, A, b) layout with A = ``max_active_sweeps``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_lib
from .limits import limit

__all__ = ["bulge_wavefront_cuda"]

_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _P, _P, _P, ctypes.c_int, _P]


def _lib():
    fn = cuda_lib.library("bulge").bulge_wavefront_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def bulge_wavefront_cuda(
    B: torch.Tensor, b: int, *, return_log: bool = False, group: Optional[int] = None
):
    """Kernel B: band (dense (n, n) float32 CUDA tensor, bandwidth ``b``) ->
    tridiagonal.  Returns ``T`` or ``(T, ChaseLog)``; ``B`` is not modified.
    ``group`` is the number of slots per CTA (default: the ``cuda`` row of
    ``repro_torch.solver.autotune.wavefront_group``)."""
    from repro_torch.core.bulge_chasing import (
        ChaseLog, _trivial_log, max_active_sweeps, num_wavefronts,
    )
    from repro_torch.solver.autotune import wavefront_group

    if not B.is_cuda:
        raise ValueError(f"bulge_wavefront_cuda needs a CUDA tensor, got {B.device}")
    if B.dtype != torch.float32:
        raise ValueError(f"bulge_wavefront_cuda takes float32, got {B.dtype}")
    if B.ndim != 2 or B.shape[0] != B.shape[1]:
        raise ValueError(f"expected a square matrix, got {tuple(B.shape)}")
    n = B.shape[0]
    if n < 3 or b <= 1:  # no chase op exists: T == B
        T = B.clone()
        return (T, _trivial_log(B, b)) if return_log else T
    smem = (9 * b * b + 9 * b) * 4  # the 3b x 3b window and three 3b vectors
    if smem > limit("SMEM_PER_BLOCK_MAX"):
        raise ValueError(f"b={b} needs {smem} bytes of shared memory per CTA; the card has "
                         f"{limit('SMEM_PER_BLOCK_MAX')}")
    A = max_active_sweeps(n, b)
    W = num_wavefronts(n, b)
    G = max(1, min(int(group or wavefront_group(n, b, "cuda")), A))
    T = torch.empty((n, n), dtype=torch.float32, device=B.device)
    T.copy_(B)
    kw = dict(device=B.device)
    if return_log:
        vs = torch.empty((W, A, b), dtype=torch.float32, **kw)
        taus = torch.empty((W, A), dtype=torch.float32, **kw)
        row0 = torch.empty((W, A), dtype=torch.int32, **kw)
    else:
        vs = taus = torch.empty((1,), dtype=torch.float32, **kw)
        row0 = torch.empty((1,), dtype=torch.int32, **kw)
    fn = _lib()
    with torch.cuda.device(B.device):
        err = fn(
            T.data_ptr(), n, b, A, G, vs.data_ptr(), taus.data_ptr(), row0.data_ptr(),
            int(return_log), torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, "bulge_wavefront")
    cuda_lib.count("bulge_wavefront", W)
    if not return_log:
        return T
    return T, ChaseLog(vs=vs, taus=taus, row0=row0, n=n, b=b)
