"""Per-device blocking tables for the two-stage pipeline.

Port of ``repro.solver.autotune``.  The JAX package keys its tables by
platform (``tpu`` or anything else); the port keys them by device type:

* ``cuda`` rows are, for now, a copy of the JAX package's ``tpu`` rows
  (b = 8, nb = 256 at n >= 1024; WY group 16 at n >= 1024).  They have not
  been tuned on the H100: that is a later PR's work.
* ``cpu`` rows are the JAX package's non-TPU rows, so a CPU plan of the
  port resolves the same blocking as the JAX package does on the CPU (the
  parity tests rely on it).

``resolve_blocking`` clamps exactly as the JAX package does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = [
    "BlockingDecision",
    "resolve_blocking",
    "blocking_defaults",
    "backtransform_group",
]

# device type -> ((n_upper_exclusive | None, b, nb), ...) scanned in order.
_BLOCKING_TABLE = {
    "cuda": ((256, 8, 64), (1024, 8, 128), (None, 8, 256)),
    "cpu": ((128, 8, 32), (None, 8, 64)),
}
# Blocked back-transform WY group size G, (n_upper_exclusive | None, G).
_BT_GROUP_TABLE = {
    "cuda": ((1024, 8), (None, 16)),
    "cpu": ((None, 8),),
}
def _lookup(table, n: int, device_type: str):
    for row in table[device_type]:
        if row[0] is None or n < row[0]:
            return row[1:]
    raise AssertionError("tables end with a None bound")


def blocking_defaults(n: int, device_type: str = "cuda"):
    """Table (b, nb) for an n x n problem on ``device_type``."""
    return _lookup(_BLOCKING_TABLE, n, device_type)


def backtransform_group(n: int, b: int, device_type: str = "cuda") -> int:
    """WY group size G, clamped to [1, K] (K reflectors per sweep)."""
    from repro_torch.core.backtransform import _sweep_shape

    (g,) = _lookup(_BT_GROUP_TABLE, n, device_type)
    _, K = _sweep_shape(n, b)
    return max(1, min(int(g), K))


@dataclasses.dataclass(frozen=True)
class BlockingDecision:
    """Resolved (b, nb) plus an explicit record of any degradation."""

    b: int
    nb: int
    fallback_reason: Optional[str] = None

    @property
    def degenerate(self) -> bool:
        return self.fallback_reason is not None


def resolve_blocking(
    n: int,
    b: Optional[int] = None,
    nb: Optional[int] = None,
    device_type: str = "cuda",
) -> BlockingDecision:
    """Blocking for an n x n two-stage reduction: explicit values win over
    the table; b halves until it divides n; nb becomes a multiple of b no
    larger than n.  A collapse to b == 1 carries a ``fallback_reason``."""
    tb, tnb = blocking_defaults(n, device_type)
    requested_b = tb if b is None else int(b)
    nb = tnb if nb is None else int(nb)
    b = requested_b
    while b > 1 and n % b != 0:
        b //= 2
    b = max(b, 1)
    nb = max((min(nb, n) // b) * b, b)
    reason = None
    if b <= 1 and n > 2:
        reason = (
            f"blocking collapsed to b=1 (n={n} has no power-of-two factor of "
            f"requested b={requested_b}); using direct one-stage "
            f"tridiagonalization"
        )
    return BlockingDecision(b=b, nb=nb, fallback_reason=reason)
