"""Frozen copy of the port's kernel work formulas (``kernels/work.py``).

The benchmark's rooflines divide these bounds by measured times, so the
yardstick lives here, where a change to the program cannot move it.
``evdbench/tests/test_yardstick.py`` holds it equal to the port's own
formulas at every cell's shapes as of the commit that froze it; when the
port's formulas change, that test fails and a benchmark change decides.

The original's description:

The work of each hand-written kernel, from its input shapes alone.

One function per kernel (A–E), each returning a :class:`Work`: the bytes
the function must move (each input read once, each output written once)
and the operations its algorithm needs, each at the rate it runs at.  These
are the single source of two numbers: the FLOPs that
``torch.utils.flop_counter`` (and so ``repro_torch.analysis``) counts for
the ``repro_torch`` operators (``kernels/library.py``), and the least time
the card could take for the same work (``chip_smoke.py`` phase 2's
``bound_ms``).  Whatever implements a kernel, its count stays the same.

Where the work depends on the data (the chase's active slots, the
back-transform's live reflectors), it is taken from the static schedule:
by the parity contract an inactive slot of the chase log has ``tau == 0``,
so the live reflectors are exactly the schedule's chase ops.

A call on a bucket of ``batch`` matrices (kernels A–D) does ``batch``
times one matrix's work and moves ``batch`` times its bytes.

Rates: ``"fp32"`` (float32 outside the tensor cores), ``"tf32x3"``
(float32 on the tensor cores as three TF32 products a product: kernel D in
float32 and kernel A's trailing update) and ``"bf16"`` (tensor cores).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = [
    "Work",
    "chase_ops",
    "fused_panel_update",
    "bulge_wavefront",
    "backtransform_wy",
    "syr2k",
    "panel_qr",
]


@dataclasses.dataclass(frozen=True)
class Work:
    """``bytes`` moved and ``flops``: ``(operations, rate)`` pairs."""

    bytes: float
    flops: Tuple[Tuple[float, str], ...]

    @property
    def total_flops(self) -> float:
        return sum(f for f, _ in self.flops)

    def times(self, batch: int) -> "Work":
        """The work of ``batch`` such calls in one."""
        return Work(self.bytes * batch, tuple((f * batch, rate) for f, rate in self.flops))


def chase_ops(n: int, b: int) -> int:
    """The bulge chase's ops (one reflector each) on an (n, n) band of
    bandwidth ``b``: sweep s makes ``(n - 3 - s) // b + 1`` of them."""
    if n < 3 or b <= 1:
        return 0
    return sum((n - 3 - s) // b + 1 for s in range(n - 2))


def fused_panel_update(m: int, w: int, b: int, *, batch: int = 1) -> Work:
    """Kernel A on an (m, m) trailing view, ``w`` columns in panels of
    ``b``: the q = w/b panel QRs with their GEMVs against the view (fp32),
    then the rank-2w trailing update of the (m - w) block (3xTF32).  Bytes:
    the view read and written, V (m, w) and the q (b, b) T factors."""
    q = w // b
    panels = sum(2.0 * m * (m - (j + 1) * b) * b + 12.0 * m * j * b * b for j in range(q))
    trailing = 2.0 * (m - w) * (m - w) * w
    return Work((2.0 * m * m + m * w + q * b * b) * 4, ((panels, "fp32"), (trailing, "tf32x3"))).times(batch)


def bulge_wavefront(n: int, b: int, *, log: bool = True, batch: int = 1) -> Work:
    """Kernel B on an (n, n) band: 26 b^2 operations a chase op; bytes the
    band read and T written, plus the (W, A) log of b + 2 words a slot."""
    nbytes = 2.0 * n * n * 4
    if log and n >= 3 and b > 1:
        W = 3 * (n - 3) + 1
        A = ((n - 3) // b + 3) // 3 + 1
        nbytes += W * A * (b + 2) * 4.0
    return Work(nbytes, ((26.0 * b * b * chase_ops(n, b), "fp32"),)).times(batch)


def backtransform_wy(n: int, m: int, S: int, K: int, b: int, *, batch: int = 1) -> Work:
    """Kernel C: each of the chase's reflectors (length b) applied to the m
    columns of X (n, m), 4 b m operations each; bytes X read, the result
    written and the (S, K) sweep-major log."""
    return Work((2.0 * n * m + S * K * (b + 1)) * 4, ((4.0 * b * chase_ops(n, b) * m, "fp32"),)).times(batch)


def syr2k(n: int, k: int, *, with_c: bool = True, itemsize: int = 4, batch: int = 1) -> Work:
    """Kernel D: the lower triangle of C + alpha (A B^T + B A^T), 4 k
    operations an entry; bytes A and B (n, k), C's lower triangle (when
    given) and the (n, n) result, at ``itemsize`` bytes an entry (float32:
    3xTF32; bfloat16: the bf16 tensor cores)."""
    lower = n * (n + 1) / 2
    nbytes = (2.0 * n * k + (lower if with_c else 0.0) + n * n) * itemsize
    return Work(nbytes, ((4.0 * k * lower, "tf32x3" if itemsize == 4 else "bf16"),)).times(batch)


def panel_qr(m: int, b: int) -> Work:
    """Kernel E: b Householder steps down an (m, b) panel and the T
    recurrence; bytes the panel read, V written, T, R and taus."""
    flops = sum(3.0 * (m - j) + 4.0 * (m - j) * (b - 1 - j) + 2.0 * (m - j) * j for j in range(b)) + b ** 3 / 3.0
    return Work((2.0 * m * b + 2.0 * b * b + b) * 4, ((flops, "fp32"),))
