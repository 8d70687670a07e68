"""BatchPlan: the stacked sibling of :class:`EvdPlan`.

Port of ``repro.solver.batch``.  The regime that fills an accelerator is
many matrices at once (Shampoo's preconditioner refresh, EVD serving).  A
:class:`BatchPlan` freezes one (n, batch, dtype, config, device) stacked
solve as ``EvdPlan`` freezes one solve, and lives in the same plan cache.
It runs the bucket executor of ``repro_torch.solver.plan``: the plain
stages once over the whole stack, the kernels once per matrix.

:class:`PadPolicy` is the executor's contract for making ragged work fit
rectangular plans: pad matrices up to a bucket size with a ridge-identity
block, and pad the batch count to a multiple.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from .config import EvdConfig
from .plan import _PLAN_CACHE, EvdPlan, _dtype_name, _execute_bucket, _roots_from_window
from .plan import plan as _plan

__all__ = ["PadPolicy", "BatchPlan", "batch_plan"]


@dataclasses.dataclass(frozen=True)
class PadPolicy:
    """How ``solve_many`` makes ragged work fit rectangular plans.

    * ``bucket_sizes`` — allowed matrix sizes.  ``None`` (default) buckets
      by exact n.  When given (e.g. ``(32, 64, 128)``), every matrix is
      embedded in the smallest bucket >= its n as ``blockdiag(A, fill * I)``,
      with ``fill`` strictly above the matrix's Gershgorin bound, so the
      real spectrum takes the first n ascending positions and a slice
      recovers it.  ``inverse_pth_root`` on a padded bucket runs eigh and
      rebuilds ``V root(w) V^T`` from the real eigenpair window only.
      Padded results are approximate (the blocks decouple exactly only in
      exact arithmetic).
    * ``batch_multiple`` — pad each bucket's matrix count up to a multiple
      with identity matrices, dropped on the scatter.
    * ``ridge`` — relative margin of the fill above the Gershgorin bound.
    * ``donate`` — accepted for the JAX package's signature and ignored:
      torch has no buffer donation, and the executor never writes the
      stack it is given (the symmetrized copy is its own), so the caller's
      tensor is never written either way.
    """

    bucket_sizes: Optional[Tuple[int, ...]] = None
    batch_multiple: int = 1
    ridge: float = 1e-2
    donate: bool = False

    def __post_init__(self):
        if self.bucket_sizes is not None:
            sizes = tuple(sorted(int(s) for s in self.bucket_sizes))
            if not sizes or any(s < 1 for s in sizes):
                raise ValueError(f"bucket_sizes must be positive, got {self.bucket_sizes}")
            object.__setattr__(self, "bucket_sizes", sizes)
        if self.batch_multiple < 1:
            raise ValueError(f"batch_multiple must be >= 1, got {self.batch_multiple}")
        if self.ridge <= 0.0:
            raise ValueError(f"ridge must be > 0, got {self.ridge}")

    def bucket_for(self, n: int) -> int:
        """The bucket size ``n`` lands in (== n when bucketing is exact)."""
        if self.bucket_sizes is None:
            return n
        for s in self.bucket_sizes:
            if s >= n:
                return s
        raise ValueError(
            f"matrix size n={n} exceeds every bucket in bucket_sizes="
            f"{self.bucket_sizes}; add a larger bucket"
        )


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """A cached solver for a stack of ``batch`` (n, n) matrices, from
    :func:`batch_plan`.  ``w, V = bpl(A)`` on a (batch, n, n) stack gives
    (batch, k) and (batch, n, k).

    ``donate`` is accepted on every call for the JAX package's signature
    and ignored: torch has no buffer donation, and the executor works on its
    own symmetrized copy, so the caller's tensor is never written.
    """

    base: EvdPlan
    batch: int

    @property
    def n(self) -> int:
        return self.base.n

    @property
    def dtype(self) -> str:
        return self.base.dtype

    @property
    def config(self) -> EvdConfig:
        return self.base.config

    @property
    def backend(self) -> str:
        return self.base.backend

    @property
    def device(self) -> str:
        return self.base.device

    @property
    def k(self) -> int:
        return self.base.k

    def _check_operand(self, A: torch.Tensor) -> None:
        if tuple(A.shape) != (self.batch, self.n, self.n):
            raise ValueError(
                f"batch plan built for shape {(self.batch, self.n, self.n)}, got {tuple(A.shape)}"
            )
        got = _dtype_name(A.dtype)
        if got != self.dtype:
            raise ValueError(f"batch plan built for dtype {self.dtype}, got {got}")
        if A.device != torch.device(self.device):
            raise ValueError(f"batch plan built for device {self.device}, got {A.device}")

    def __call__(self, A: torch.Tensor, *, eigenvectors: bool = True, donate: bool = False):
        """``(w, V)`` of shapes (batch, k) / (batch, n, k), or ``w``."""
        self._check_operand(A)
        return _execute_bucket(A, self.base, eigenvectors)

    def eigvals(self, A: torch.Tensor, *, donate: bool = False) -> torch.Tensor:
        self._check_operand(A)
        return _execute_bucket(A, self.base, False)

    def inverse_pth_root(
        self, A: torch.Tensor, p: int, *, eps: float = 1e-6, donate: bool = False
    ) -> torch.Tensor:
        """Stacked A^{-1/p} for symmetric PSD matrices (Shampoo's refresh)."""
        self.base._require_full_spectrum()
        self._check_operand(A)
        w, V = _execute_bucket(A, self.base, True)
        return _roots_from_window(w, V, p, eps)

    def describe(self) -> str:
        return f"BatchPlan(batch={self.batch}, base={self.base.describe()})"


def batch_plan(
    n: int,
    batch: int,
    dtype=torch.float32,
    config: EvdConfig = EvdConfig(),
    device: Optional[Union[str, torch.device]] = None,
) -> BatchPlan:
    """Resolve a stacked (batch, n, n) solve on ``device`` (default
    ``"cuda"``).  Cached beside the single plans: equal arguments return the
    identical :class:`BatchPlan`."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    base = _plan(n, dtype, config, device)
    key = ("batch", batch, n, base.dtype, config, base.backend, base.device, base.tridiag)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        return cached
    bpl = BatchPlan(base=base, batch=int(batch))
    _PLAN_CACHE[key] = bpl
    return bpl
