"""Plan/execute split for the symmetric EVD pipeline.

    cfg = EvdConfig(spectrum=by_count(8))        # how to solve
    pl  = plan(n, torch.float32, cfg)            # resolve + cache (on "cuda")
    w, V = pl(A)                                 # execute

``plan`` resolves everything shape-dependent once (blocking from the
per-device table, the kernel backend, the bisection budget, the spectrum
window) into a frozen :class:`EvdPlan`.  Plans are cached: the same
(n, dtype, config, device) returns the same object.  PyTorch runs eagerly,
so there is no trace to cache and no trace counter.

The device defaults to ``"cuda"``; with no card, planning raises unless the
caller passes ``device="cpu"``.  The port runs ``method="two_stage"`` with
``chase="wavefront"`` and ``backtransform="blocked"``, in both first-stage
generations (``tridiag="fused"``, the default, and ``"unfused"``); the
other options raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.backend import probe, registry
from repro_torch.core import backtransform as bt
from repro_torch.core.band_reduction import band_reduce
from repro_torch.core.bulge_chasing import band_to_tridiag, extract_tridiag
from repro_torch.core.tridiag_eig import eigvalsh_tridiag_range, eigvecs_inverse_iteration

from .autotune import backtransform_group, resolve_blocking
from .config import EvdConfig

__all__ = ["EvdPlan", "plan", "plan_for", "clear_plan_cache", "plan_cache_size"]

_DEFAULT_BISECT_ITERS = 48
_LATER = "ROADMAP Queue 1 item 8"


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    name = getattr(dtype, "name", None) or str(dtype)
    if not isinstance(getattr(torch, name, None), torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return name


@dataclasses.dataclass(frozen=True)
class EvdPlan:
    """A resolved, cached EVD solver for one (n, dtype, config, device).

    ``w, V = plan(A)``; ``w = plan.eigvals(A)``;
    ``X = plan.inverse_pth_root(A, p)``.
    """

    n: int
    dtype: str
    config: EvdConfig
    b: int
    nb: int
    bisect_iters: int
    backend: str
    device: str
    bt_group: int = 0
    tridiag: str = "fused"

    @property
    def method(self) -> str:
        return self.config.method

    @property
    def spectrum_range(self) -> Tuple[int, int]:
        return self.config.spectrum.index_range(self.n)

    @property
    def k(self) -> int:
        return self.spectrum_range[1]

    def _check_operand(self, A: torch.Tensor) -> None:
        if tuple(A.shape[-2:]) != (self.n, self.n) or A.ndim != 2:
            raise ValueError(
                f"plan built for one (n, n) = ({self.n}, {self.n}) matrix, got "
                f"operand shape {tuple(A.shape)}; batched solves are not ported "
                "yet: ROADMAP Queue 1 item 9"
            )
        got = _dtype_name(A.dtype)
        if got != self.dtype:
            raise ValueError(f"plan built for dtype {self.dtype}, got {got}")
        if A.device != torch.device(self.device):
            raise ValueError(f"plan built for device {self.device}, got {A.device}")

    def __call__(self, A: torch.Tensor, *, eigenvectors: bool = True):
        """Returns ``(w, V)`` or ``w``; ``w`` ascending (k,), ``V`` (n, k)."""
        self._check_operand(A)
        return _execute(A, self, eigenvectors)

    def eigvals(self, A: torch.Tensor) -> torch.Tensor:
        self._check_operand(A)
        return _execute(A, self, False)

    def inverse_pth_root(self, A: torch.Tensor, p: int, *, eps: float = 1e-6):
        """A^{-1/p} for symmetric PSD A (the Shampoo preconditioner)."""
        if not self.config.spectrum.is_full:
            raise ValueError(
                "inverse_pth_root needs the full spectrum; this plan selects "
                f"{self.config.spectrum}"
            )
        self._check_operand(A)
        w, V = _execute(A, self, True)
        wmax = torch.clamp(w.max(), min=0.0)
        ridge = eps * torch.clamp(wmax, min=1e-30)
        root = torch.pow(torch.clamp(w, min=0.0) + ridge, -1.0 / p)
        return (V * root[None, :]) @ V.T

    def describe(self) -> str:
        return (
            f"EvdPlan(n={self.n}, {self.dtype}, method={self.method}, "
            f"b={self.b}, nb={self.nb}, backend={self.backend}, "
            f"device={self.device}, k={self.k}/{self.n}, tridiag={self.tridiag}, "
            f"backtransform={self.config.backtransform}[G={self.bt_group}])"
        )


_PLAN_CACHE: Dict[tuple, EvdPlan] = {}


def _bisect_iters(tol: Optional[float]) -> int:
    if tol is None:
        return _DEFAULT_BISECT_ITERS
    return max(8, min(64, int(math.ceil(math.log2(1.0 / tol))) + 1))


def _check_scope(config: EvdConfig) -> None:
    for field, value, ported in (
        ("method", config.method, "two_stage"),
        ("chase", config.chase, "wavefront"),
        ("backtransform", config.backtransform, "blocked"),
    ):
        if value != ported:
            raise NotImplementedError(
                f"EvdConfig({field}={value!r}) is not ported yet: {_LATER}"
            )


def plan(
    n: int,
    dtype=torch.float32,
    config: EvdConfig = EvdConfig(),
    device: Optional[Union[str, torch.device]] = None,
) -> EvdPlan:
    """Resolve ``config`` for an (n, n) ``dtype`` problem on ``device``
    (default ``"cuda"``).  Equal arguments return the identical plan."""
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    dev = probe.resolve_device(device)
    dtype_name = _dtype_name(dtype)
    backend = (
        registry.validate_backend(config.backend)
        if config.backend is not None
        else registry.default_backend(dev)
    )
    key = (n, dtype_name, config, str(dev), backend)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        return cached

    _check_scope(config)
    config.spectrum.index_range(n)
    if backend == "cuda":
        if dev.type != "cuda":
            raise ValueError(f"backend='cuda' needs a CUDA device, got {dev}")
        probe.require_hopper(dev)
        if dtype_name != "float32":
            raise NotImplementedError(
                f"the CUDA kernels take float32; got {dtype_name}"
            )
    dec = resolve_blocking(n, b=config.b, nb=config.nb, device_type=dev.type)
    if dec.fallback_reason:
        raise NotImplementedError(
            f"{dec.fallback_reason}; the direct method is not ported yet: {_LATER}"
        )
    pl = EvdPlan(
        n=n,
        dtype=dtype_name,
        config=config,
        b=dec.b,
        nb=dec.nb,
        bisect_iters=_bisect_iters(config.tol),
        backend=backend,
        device=str(dev),
        bt_group=backtransform_group(n, dec.b, dev.type),
        tridiag=config.tridiag or "fused",
    )
    _PLAN_CACHE[key] = pl
    return pl


def plan_for(A: torch.Tensor, config: EvdConfig = EvdConfig()) -> EvdPlan:
    """Plan from a tensor's (n, n) shape, dtype and device."""
    if A.ndim != 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"expected one square matrix, got shape {tuple(A.shape)}")
    return plan(A.shape[-1], A.dtype, config, A.device)


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()


def plan_cache_size() -> int:
    return len(_PLAN_CACHE)


def _tridiag_pipeline(A, pl: EvdPlan, *, return_reflectors: bool, on_stage=None):
    """Symmetric A -> (d, e) [+ (BandReflectors, ChaseLog)]."""
    mark = on_stage or (lambda name: None)
    if not return_reflectors:
        B = band_reduce(A, pl.b, pl.nb, mode=pl.tridiag, backend=pl.backend)
        mark("band_reduce")
        T = band_to_tridiag(B, pl.b, mode=pl.tridiag, backend=pl.backend)
        mark("chase")
        return extract_tridiag(T)
    B, refl1 = band_reduce(
        A, pl.b, pl.nb, return_reflectors=True, merge_ts=True, mode=pl.tridiag,
        backend=pl.backend,
    )
    mark("band_reduce")
    T, log2 = band_to_tridiag(B, pl.b, return_log=True, mode=pl.tridiag, backend=pl.backend)
    mark("chase")
    d, e = extract_tridiag(T)
    return d, e, (refl1, log2)


def _execute(
    A: torch.Tensor,
    pl: EvdPlan,
    eigenvectors: bool,
    on_stage: Optional[Callable[[str], None]] = None,
):
    """The main path.  ``on_stage(name)``, when given, is called as each
    stage ends (``chip_smoke.py`` closes each with a synchronize)."""
    mark = on_stage or (lambda name: None)
    start, count = pl.spectrum_range
    A = 0.5 * (A + A.T)
    if not eigenvectors:
        d, e = _tridiag_pipeline(A, pl, return_reflectors=False, on_stage=on_stage)
        w = eigvalsh_tridiag_range(d, e, start=start, count=count, max_iter=pl.bisect_iters)
        mark("bisection")
        return w
    d, e, (refl1, log2) = _tridiag_pipeline(
        A, pl, return_reflectors=True, on_stage=on_stage
    )
    w = eigvalsh_tridiag_range(d, e, start=start, count=count, max_iter=pl.bisect_iters)
    mark("bisection")
    VT = eigvecs_inverse_iteration(d, e, w)
    mark("inverse_iteration")
    X = bt.apply_q2_blocked(log2, VT, group=pl.bt_group, backend=pl.backend, on_stage=on_stage)
    mark("q2")
    V = bt.apply_q_left_blocked(refl1, X)
    mark("q1")
    return w, V
