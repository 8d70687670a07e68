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
PANEL_QR_SMEM           204800   kernel A's panel QR keeps the (m - r0, b)
                                 panel, and kernel E its (m, b) panel, in
                                 shared memory up to this size, and works on
                                 it in global memory above it
BACKTRANSFORM_SMEM      114688   kernel C keeps its (n, cw) column strip in
                                 shared memory up to this size (two blocks per
                                 SM), and works in global memory above it
=====================  ========  ===============================================
"""
from __future__ import annotations

__all__ = ["LIMITS", "limit"]

LIMITS = {
    "SMEM_PER_BLOCK_MAX": 232448,
    "PANEL_QR_SMEM": 200 * 1024,
    "BACKTRANSFORM_SMEM": 112 * 1024,
}


def limit(name: str) -> int:
    if name not in LIMITS:
        raise KeyError(f"unknown kernel limit {name!r}; expected one of {sorted(LIMITS)}")
    return LIMITS[name]
