"""Per-CTA resource budgets of the Hopper kernels.

The JAX package's ceilings (``repro.kernels.limits``) gate whole-matrix
VMEM residency and hand larger problems to XLA.  The port has no such
ceiling: every kernel takes every shape the main path gives it, and only
chooses WHERE a working set lives.  The numbers here are the H100's
(NVIDIA Hopper architecture documentation): a block may use up to 227 KB of shared
memory, requested as dynamic shared memory above 48 KB.

=====================  ========  ===============================================
name                   bytes     used by
=====================  ========  ===============================================
SMEM_PER_BLOCK_MAX      232448   the hardware ceiling (227 KB) for one block;
                                 kernel B's 3b x 3b window must fit it
PANEL_QR_SMEM           204800   the cluster panel QR of kernels A and E
                                 keeps each CTA's slice of the panel's rows
                                 in shared memory up to this size, and works
                                 on it in a global workspace above
BACKTRANSFORM_SMEM      188416   kernel C keeps its (n, cw) column strip in
                                 shared memory up to this size (one block per
                                 SM, beside its 40.5 KB of staged log), and
                                 works in global memory above it
=====================  ========  ===============================================

A bucket of matrices is one call of each kernel (kernels A, C and D take
the matrix from ``blockIdx.y``, which stops at ``GRID_ROWS`` = 65 535;
kernel B's persistent grid takes it from its ticket).  A bucket larger than
:func:`bucket_chunk` matrices runs in the fewest chunks that fit it
(``solver/plan.py``), so that a chunk's grid fits ``gridDim.y`` and its
input stays within ``BUCKET_BYTES`` (2 GiB: the 14 560 blocks of 128 of
recurrentgemma-2b's refresh are 0.95 GB, one chunk).  A refresh's peak is
21 to 24 times its input (2055 to 2327 MiB for chip_smoke.py phase 6a's
1536 blocks of 128 on an H100: the kernels' buffers and logs, the
eigenvectors, the float64 Rayleigh-Ritz step), so a refresh of a bucket at
the cap peaks near 44 to 52 GB, within the card's 80 GB (past the cap the executor's
stages peak a chunk at a time; the root's Rayleigh-Ritz step still takes
the whole bucket).
:func:`bucket_calls` is the number of calls of each op a bucket makes;
``chip_smoke.py``'s launch gates read it.

``PANEL_QR_CLUSTER`` is not a size in bytes: it is the most CTAs of the
thread-block cluster over which kernels A and E split each panel QR's rows
(16, Hopper's non-portable maximum; the kernels fall back to the portable 8
when the card cannot co-schedule 16).  With ``PANEL_QR_SMEM`` each CTA
keeps its slice of the panel in shared memory.
"""
from __future__ import annotations

__all__ = ["LIMITS", "limit", "grid_rows", "bucket_chunk", "bucket_calls"]

LIMITS = {
    "SMEM_PER_BLOCK_MAX": 232448,
    "PANEL_QR_SMEM": 200 * 1024,
    "BACKTRANSFORM_SMEM": 184 * 1024,
    "PANEL_QR_CLUSTER": 16,
    "GRID_ROWS": 65535,
    "BUCKET_BYTES": 2 ** 31,
}


def limit(name: str) -> int:
    if name not in LIMITS:
        raise KeyError(f"unknown kernel limit {name!r}; expected one of {sorted(LIMITS)}")
    return LIMITS[name]


def grid_rows() -> int:
    """The most matrices one kernel call takes (``gridDim.y``)."""
    return limit("GRID_ROWS")


def bucket_chunk(n: int) -> int:
    """The most (n, n) float32 matrices of a bucket that run as one chunk."""
    return max(1, min(grid_rows(), limit("BUCKET_BYTES") // (4 * n * n)))


def bucket_calls(batch: int, n: int) -> int:
    """Chunks of a bucket of ``batch`` (n, n) matrices: the calls of each
    kernel op per static step of its solve."""
    return -(-batch // bucket_chunk(n))
