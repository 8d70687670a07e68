"""Launcher of kernel B, ``csrc/bulge.cu`` (the bulge chase).

Replaces ``repro.kernels.bulge.bulge_wavefront_pallas`` and its wrapper
``repro.kernels.ops.bulge_wavefront`` (minus the fallback).  One call is
one CUDA launch: a persistent grid whose CTAs take the sweeps in order and
hand them on through flags.  A bucket of bands (B, n, n) is one launch too
(one grid over every matrix's sweeps), as ``jax.vmap`` makes the Pallas
kernel one call.  The log comes out in the plain version's (W, A, b)
layout with A = ``max_active_sweeps``, one a matrix.

While ``backend.trace`` records, a call also passes the kernel 3 zeroed
counters (``trace.device_counters``, kept with the span of the op that
called it): the cycles its CTAs spent waiting on the previous sweep, the
cycles of their ops after the wait, and the ops, as
``kernel_b.wait_cycles``, ``kernel_b.op_cycles`` and ``kernel_b.ops``.
T and the log are the same with them or without.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.backend import trace

from . import cuda_lib
from .limits import limit

__all__ = ["STATS", "bulge_wavefront_cuda"]

STATS = ("kernel_b.wait_cycles", "kernel_b.op_cycles", "kernel_b.ops")
_P = ctypes.c_void_p
_ARGTYPES = [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             _P, _P, _P, ctypes.c_int, _P, ctypes.c_int, _P, _P]
_WORKSPACE_ARGTYPES = [ctypes.c_int, ctypes.c_int]


def _lib():
    lib = cuda_lib.library("bulge")
    fn, ws = lib.bulge_wavefront_launch, lib.bulge_wavefront_workspace
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    ws.argtypes, ws.restype = _WORKSPACE_ARGTYPES, ctypes.c_longlong
    return fn, ws


def bulge_wavefront_cuda(B: torch.Tensor, b: int, *, return_log: bool = False):
    """Kernel B: band (dense (n, n) float32 CUDA tensor, bandwidth ``b``),
    or a bucket of bands (B, n, n), -> tridiagonal.  Returns ``T`` or
    ``(T, ChaseLog)`` with leading dimensions as ``B``'s; ``B`` is not
    modified.  The persistent grid has as many CTAs as the card keeps
    resident, at most the sweeps that can be in flight."""
    from repro_torch.core.bulge_chasing import (
        ChaseLog, _trivial_log, max_active_sweeps, num_wavefronts,
    )

    if not B.is_cuda:
        raise ValueError(f"bulge_wavefront_cuda needs a CUDA tensor, got {B.device}")
    if B.dtype != torch.float32:
        raise ValueError(f"bulge_wavefront_cuda takes float32, got {B.dtype}")
    if B.ndim not in (2, 3) or B.shape[-1] != B.shape[-2]:
        raise ValueError(f"expected a square matrix (n, n) or a bucket (B, n, n), got {tuple(B.shape)}")
    n = B.shape[-1]
    lead = tuple(B.shape[:-2])
    batch = B.shape[0] if lead else 1
    if n < 3 or b <= 1:  # no chase op exists: T == B
        T = B.clone()
        return (T, _trivial_log(B, b)) if return_log else T
    smem = (3 * b * (3 * b + 1) + 6 * b + 1) * 4  # the padded 3b x 3b window, u, Mv, the sweep
    if smem > limit("SMEM_PER_BLOCK_MAX"):
        raise ValueError(f"b={b} needs {smem} bytes of shared memory per CTA; the card has "
                         f"{limit('SMEM_PER_BLOCK_MAX')}")
    A = max_active_sweeps(n, b)
    W = num_wavefronts(n, b)
    T = torch.empty(lead + (n, n), dtype=torch.float32, device=B.device)
    T.copy_(B)
    kw = dict(device=B.device)
    if return_log:
        vs = torch.empty(lead + (W, A, b), dtype=torch.float32, **kw)
        taus = torch.empty(lead + (W, A), dtype=torch.float32, **kw)
        row0 = torch.empty(lead + (W, A), dtype=torch.int32, **kw)
    else:
        vs = taus = torch.empty((1,), dtype=torch.float32, **kw)
        row0 = torch.empty((1,), dtype=torch.int32, **kw)
    fn, ws = _lib()
    # Scratch: every matrix's sweep progress counters and the ticket, zeroed.
    work = torch.zeros((ws(n, batch) // 4,), dtype=torch.int32, **kw)
    stats = trace.device_counters(STATS, B.device)
    with torch.cuda.device(B.device):
        err = fn(
            T.data_ptr(), n, b, A, 0, vs.data_ptr(), taus.data_ptr(),
            row0.data_ptr(), int(return_log), work.data_ptr(), batch,
            None if stats is None else stats.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    cuda_lib.check(err, "bulge_wavefront")
    cuda_lib.count("bulge_wavefront", 1)
    if not return_log:
        return T
    return T, ChaseLog(vs=vs, taus=taus, row0=row0, n=n, b=b)
