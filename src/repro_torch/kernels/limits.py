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

``PANEL_QR_CLUSTER`` is not a size in bytes: it is the most CTAs of the
thread-block cluster over which kernels A and E split each panel QR's rows
(16, Hopper's non-portable maximum; the kernels fall back to the portable 8
when the card cannot co-schedule 16).  With ``PANEL_QR_SMEM`` each CTA
keeps its slice of the panel in shared memory.
"""
from __future__ import annotations

__all__ = ["LIMITS", "limit"]

LIMITS = {
    "SMEM_PER_BLOCK_MAX": 232448,
    "PANEL_QR_SMEM": 200 * 1024,
    "BACKTRANSFORM_SMEM": 184 * 1024,
    "PANEL_QR_CLUSTER": 16,
}


def limit(name: str) -> int:
    if name not in LIMITS:
        raise KeyError(f"unknown kernel limit {name!r}; expected one of {sorted(LIMITS)}")
    return LIMITS[name]
