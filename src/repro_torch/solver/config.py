"""Solver configuration: what to compute, separate from the shape.

``EvdConfig`` and ``Spectrum`` are re-declared here (the port imports
nothing of the JAX package) with the same fields, defaults and validation
as ``repro.solver.config``, so a config built for one package converts to
the other field by field (``repro_torch.interop.evd_config``).

The option sets are the JAX package's, and the port runs all of them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["Spectrum", "EvdConfig", "full_spectrum", "by_index", "by_count"]

METHODS = ("two_stage", "direct", "jacobi")
CHASES = ("wavefront", "sequential")
BACKTRANSFORMS = ("blocked", "scan")
TRIDIAGS = ("fused", "unfused")


@dataclasses.dataclass(frozen=True)
class Spectrum:
    """Which eigenpairs to compute.  Construct via the classmethods.

    * ``Spectrum.all()``                 — the full spectrum (default).
    * ``Spectrum.by_index(lo, hi)``      — eigenvalues ``lo .. hi-1`` in
      ascending order (half-open).
    * ``Spectrum.by_count(k, largest=)`` — the ``k`` largest (default) or
      smallest eigenpairs.

    Selected eigenvalues are returned ascending; eigenvector column ``j``
    pairs with eigenvalue ``j`` of the selection.
    """

    kind: str = "all"        # "all" | "index" | "count"
    lo: int = 0              # [lo, hi) for kind == "index"
    hi: int = 0
    k: int = 0               # for kind == "count"
    largest: bool = True

    @classmethod
    def all(cls) -> "Spectrum":
        return cls()

    @classmethod
    def by_index(cls, lo: int, hi: int) -> "Spectrum":
        if not (0 <= lo < hi):
            raise ValueError(f"by_index needs 0 <= lo < hi, got lo={lo}, hi={hi}")
        return cls(kind="index", lo=int(lo), hi=int(hi))

    @classmethod
    def by_count(cls, k: int, largest: bool = True) -> "Spectrum":
        if k < 1:
            raise ValueError(f"by_count needs k >= 1, got k={k}")
        return cls(kind="count", k=int(k), largest=bool(largest))

    @property
    def is_full(self) -> bool:
        return self.kind == "all"

    def index_range(self, n: int):
        """Resolve to ``(start, count)`` in the ascending spectrum of size n."""
        if self.kind == "all":
            return 0, n
        if self.kind == "index":
            if self.hi > n:
                raise ValueError(f"by_index({self.lo}, {self.hi}) out of range for n={n}")
            return self.lo, self.hi - self.lo
        if self.kind == "count":
            if self.k > n:
                raise ValueError(f"by_count(k={self.k}) out of range for n={n}")
            return (n - self.k, self.k) if self.largest else (0, self.k)
        raise ValueError(f"unknown spectrum kind {self.kind!r}")


full_spectrum = Spectrum.all
by_index = Spectrum.by_index
by_count = Spectrum.by_count


@dataclasses.dataclass(frozen=True)
class EvdConfig:
    """Frozen description of how to solve a symmetric EVD.

    * ``method``  — ``two_stage`` (the paper) | ``direct`` | ``jacobi``.
    * ``chase``   — bulge-chase schedule: ``wavefront`` | ``sequential``.
    * ``backtransform`` — ``blocked`` (compact-WY) | ``scan``.
    * ``tridiag`` — ``fused`` | ``unfused``; ``None`` = the
      ``REPRO_TORCH_TRIDIAG`` env var, else ``fused``.
    * ``b, nb``   — bandwidth / update block; ``None`` = the per-device
      table in ``repro_torch.solver.autotune``.
    * ``backend`` — kernel backend pin: ``cuda`` (the hand-written kernels)
      | ``torch`` (their plain versions).  ``None`` = the
      ``REPRO_TORCH_KERNEL_BACKEND`` env var, else the plan's device.
    * ``spectrum``— which eigenpairs to compute (see :class:`Spectrum`).
    * ``tol``     — bisection tolerance as a fraction of the Gershgorin span;
      ``None`` = iterate to float32 working precision.
    * ``max_sweeps`` — Jacobi sweep budget (ignored by other methods).
    """

    method: str = "two_stage"
    chase: str = "wavefront"
    backtransform: str = "blocked"
    tridiag: Optional[str] = None
    b: Optional[int] = None
    nb: Optional[int] = None
    backend: Optional[str] = None
    spectrum: Spectrum = Spectrum()
    tol: Optional[float] = None
    max_sweeps: int = 16

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"unknown method {self.method!r}; expected one of {METHODS}")
        if self.chase not in CHASES:
            raise ValueError(f"unknown chase {self.chase!r}; expected one of {CHASES}")
        if self.backtransform not in BACKTRANSFORMS:
            raise ValueError(
                f"unknown backtransform {self.backtransform!r}; expected one "
                f"of {BACKTRANSFORMS}"
            )
        if self.tridiag is not None and self.tridiag not in TRIDIAGS:
            raise ValueError(
                f"unknown tridiag {self.tridiag!r}; expected one of {TRIDIAGS}"
            )
        if self.b is not None and self.b < 1:
            raise ValueError(f"b must be >= 1, got {self.b}")
        if self.nb is not None and self.nb < 1:
            raise ValueError(f"nb must be >= 1, got {self.nb}")
        if self.tol is not None and not (0.0 < self.tol < 1.0):
            raise ValueError(f"tol must be in (0, 1), got {self.tol}")

    def replace(self, **kw) -> "EvdConfig":
        return dataclasses.replace(self, **kw)
