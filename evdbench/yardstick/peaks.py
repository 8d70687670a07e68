"""The card's published peaks and the least time a kernel's work can take.

NVIDIA's H100 SXM data sheet, dense rates at the full 700 W limit: 3.35
TB/s of HBM3, 67 TFLOP/s of float32 outside the tensor cores, 494.7 TFLOP/s
of TF32 on them (a 3xTF32 product costs three), 989 TFLOP/s of bf16.  A
card set below 700 W runs slower under load, so every share computed
against these peaks is printed beside the card's power limit.

The DBR schedule below is a frozen copy of the port's
``core/band_reduction.build_stage_schedule`` (the blocks kernel A is called
on), so a roofline's bound depends only on (n, b, nb).
"""
from __future__ import annotations

from typing import List, Tuple

from . import work

HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"fp32": 67e12, "tf32x3": 494.7e12 / 3, "bf16": 989e12}


def bound_s(w: work.Work) -> float:
    """The larger of the bytes over the HBM rate and the operations at
    their rates: the least time the card could take for ``w``."""
    t_bytes = w.bytes / HBM_BYTES_PER_S
    t_ops = sum(f / FLOP_PER_S[rate] for f, rate in w.flops)
    return max(t_bytes, t_ops)


def dbr_blocks(n: int, b: int, nb: int) -> List[Tuple[int, int]]:
    """(m, w) of each DBR block step: trailing side m, factored columns w."""
    out, ci = [], 0
    while n - ci > b:
        m = n - ci
        w = min(nb, m - b)
        out.append((m, w))
        ci += w
    return out


def band_reduce_bound_s(n: int, b: int, nb: int) -> float:
    """Stage 1: kernel A once a DBR block."""
    return sum(bound_s(work.fused_panel_update(m, w, b)) for m, w in dbr_blocks(n, b, nb))


def chase_bound_s(n: int, b: int) -> float:
    """Stage 2: kernel B once, with its log."""
    return bound_s(work.bulge_wavefront(n, b, log=True))
