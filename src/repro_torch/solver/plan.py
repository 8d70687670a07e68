"""Plan/execute split for the symmetric EVD pipeline.

    cfg = EvdConfig(spectrum=by_count(8))        # how to solve
    pl  = plan(n, torch.float32, cfg)            # resolve + cache (on "cuda")
    w, V = pl(A)                                 # execute

``plan`` resolves everything shape-dependent once (blocking from the
per-device table, the kernel backend, the first-stage generation, the
bisection budget, the spectrum window) into a frozen :class:`EvdPlan`.
Plans are cached: the same (n, dtype, config, device) returns the same
object.  PyTorch runs eagerly, so there is no trace to cache and no trace
counter.

The device defaults to ``"cuda"``; with no card, planning raises unless the
caller passes ``device="cpu"``.  Every option of the JAX package runs:
``method="two_stage"`` (``"direct"`` when blocking collapses to b <= 1, as
at odd n), ``"direct"`` and ``"jacobi"``; ``chase="wavefront"|"sequential"``;
``backtransform="blocked"|"scan"``; ``tridiag="fused"|"unfused"``.

One executor, :func:`_execute_bucket`, runs a stack of B matrices; a single
solve is a bucket of one.  Every stage takes the bucket as a leading
dimension, as ``jax.vmap`` does in the JAX package: the plain stages
(symmetrize, bisection, inverse iteration, the Q1 merge and apply, the Q2
regroup, and the direct and Jacobi methods) and the kernels alike, each
registry op called once per static step for the whole bucket, as the
batching rule of ``pallas_call`` gives each Pallas kernel a leading grid
axis: ``band_reduce`` one kernel A a DBR block (kernel D unfused), then
``band_to_tridiag`` one kernel B, then one kernel C for the Q2 apply.  A
bucket of more than ``kernels.limits.bucket_chunk(n)`` matrices runs in the
fewest chunks that fit (``gridDim.y`` and memory), each chunk so.  Only the
oracles (``chase="sequential"``, ``backtransform="scan"``) run a matrix at
a time.

Each stage runs in a span of ``backend.trace`` (``solve`` a bucket,
``chunk`` a chunk, then ``band_reduce``, ``chase`` or ``direct_tridiag``,
``jacobi``, ``bisection``, ``inverse_iteration``, ``q2``, ``q1``;
``tridiagonalize`` and ``ritz_root`` around those calls), which records
while a profiler or ``trace.recording()`` is on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.backend import probe, registry
from repro_torch.backend.trace import map_lanes, span
from repro_torch.core.backtransform import apply_q2_blocked_many, apply_q_left_blocked
from repro_torch.core.band_reduction import BandReflectors, apply_q_left, band_reduce
from repro_torch.core.bulge_chasing import ChaseLog, apply_q2, band_to_tridiag, extract_tridiag
from repro_torch.core.direct_tridiag import apply_q_direct, direct_tridiagonalize
from repro_torch.core.jacobi import jacobi_eigh
from repro_torch.core.tridiag_eig import eigvalsh_tridiag_range, eigvecs_inverse_iteration
from repro_torch.kernels.limits import bucket_chunk

from .autotune import backtransform_group, resolve_blocking
from .config import EvdConfig

__all__ = [
    "EvdPlan",
    "plan",
    "plan_for",
    "clear_plan_cache",
    "plan_cache_size",
    "tridiagonalize",
]

_DEFAULT_BISECT_ITERS = 48


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
    ``X = plan.inverse_pth_root(A, p)``.  A stack of matrices goes through
    ``batch_plan`` or ``solve_many``.
    """

    n: int
    dtype: str
    config: EvdConfig
    b: int                           # resolved bandwidth (0: not two-stage)
    nb: int
    bisect_iters: int
    backend: str
    device: str
    fallback_reason: Optional[str] = None
    bt_group: int = 0                # WY group of the blocked Q2 apply (0: unused)
    tridiag: str = "fused"

    @property
    def method(self) -> str:
        """The method that runs: ``direct`` when blocking collapsed to b <= 1."""
        if self.config.method == "two_stage" and self.b <= 1:
            return "direct"
        return self.config.method

    @property
    def spectrum_range(self) -> Tuple[int, int]:
        return self.config.spectrum.index_range(self.n)

    @property
    def k(self) -> int:
        return self.spectrum_range[1]

    def _check_operand(self, A: torch.Tensor) -> None:
        if A.ndim != 2 or tuple(A.shape) != (self.n, self.n):
            raise ValueError(
                f"plan built for one (n, n) = ({self.n}, {self.n}) matrix, got operand "
                f"shape {tuple(A.shape)}; for batched solves use batch_plan(n, batch, "
                "...) or solve_many(...)"
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
        self._require_full_spectrum()
        self._check_operand(A)
        A = 0.5 * (A + A.mT)
        _, V = _execute_bucket(A[None], self, True)
        return _roots_from_window(A[None], V, p, eps)[0]

    def _require_full_spectrum(self) -> None:
        if not self.config.spectrum.is_full:
            raise ValueError(
                "inverse_pth_root needs the full spectrum; this plan selects "
                f"{self.config.spectrum}"
            )

    def describe(self) -> str:
        out = (
            f"EvdPlan(n={self.n}, {self.dtype}, method={self.method}, "
            f"b={self.b}, nb={self.nb}, backend={self.backend}, "
            f"device={self.device}, k={self.k}/{self.n}, tridiag={self.tridiag}, "
            f"chase={self.config.chase}, backtransform={self.config.backtransform}"
            + (f"[G={self.bt_group}]" if self.bt_group else "")
            + ")"
        )
        return out + (f"\n  fallback: {self.fallback_reason}" if self.fallback_reason else "")


_PLAN_CACHE: Dict[tuple, object] = {}


def _bisect_iters(tol: Optional[float]) -> int:
    if tol is None:
        return _DEFAULT_BISECT_ITERS
    return max(8, min(64, int(math.ceil(math.log2(1.0 / tol))) + 1))


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
    # None = the process default, resolved now so that the env var is part
    # of the cache key.
    tridiag = config.tridiag or registry.default_tridiag()
    key = (n, dtype_name, config, str(dev), backend, tridiag)
    cached = _PLAN_CACHE.get(key)
    if cached is not None:
        return cached

    config.spectrum.index_range(n)
    if backend == "cuda":
        if dev.type != "cuda":
            raise ValueError(f"backend='cuda' needs a CUDA device, got {dev}")
        probe.require_hopper(dev)
        if dtype_name != "float32":
            raise NotImplementedError(
                f"the CUDA kernels take float32; got {dtype_name}"
            )
    b, nb, reason, bt_group = 0, 0, None, 0
    if config.method == "two_stage":
        dec = resolve_blocking(n, b=config.b, nb=config.nb, device_type=dev.type)
        b, nb, reason = dec.b, dec.nb, dec.fallback_reason
        if b > 1 and config.backtransform == "blocked":
            bt_group = backtransform_group(n, b, dev.type)
    pl = EvdPlan(
        n=n,
        dtype=dtype_name,
        config=config,
        b=b,
        nb=nb,
        bisect_iters=_bisect_iters(config.tol),
        backend=backend,
        device=str(dev),
        fallback_reason=reason,
        bt_group=bt_group,
        tridiag=tridiag,
    )
    _PLAN_CACHE[key] = pl
    return pl


def plan_for(A: torch.Tensor, config: EvdConfig = EvdConfig()) -> EvdPlan:
    """Plan from a tensor's trailing (n, n) shape, dtype and device."""
    if A.ndim < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"expected a square trailing shape, got {tuple(A.shape)}")
    return plan(A.shape[-1], A.dtype, config, A.device)


def clear_plan_cache() -> None:
    _PLAN_CACHE.clear()


def plan_cache_size() -> int:
    return len(_PLAN_CACHE)


# ------------------------------------------------------------------ pipeline
def _tridiag_bucket(
    A: torch.Tensor,
    *,
    b: int,
    nb: int,
    method: str,
    chase: str,
    tridiag: Optional[str],
    backend: Optional[str],
    return_reflectors: bool,
):
    """Symmetric (B, n, n) -> ``d`` (B, n), ``e`` (B, n-1), and with
    ``return_reflectors`` the back-transform data: ``("direct",
    DirectReflectors)`` or ``("two_stage", (BandReflectors, ChaseLog))``,
    each stacked over the bucket."""
    if method == "direct":
        with span("direct_tridiag", A):
            T, refl = direct_tridiagonalize(A, return_reflectors=True)
        d, e = extract_tridiag(T)
        return (d, e, ("direct", refl)) if return_reflectors else (d, e)
    kw = dict(mode=tridiag, backend=backend)
    with span("band_reduce", A):
        out = band_reduce(A, b, nb, return_reflectors=return_reflectors, **kw)
    if not return_reflectors:
        with span("chase", A):
            T = band_to_tridiag(out, b, method=chase, **kw)
        return extract_tridiag(T)
    band, refl = out
    with span("chase", A):
        T, log = band_to_tridiag(band, b, method=chase, return_log=True, **kw)
    d, e = extract_tridiag(T)
    return d, e, ("two_stage", (refl, log))


def _lane_log(log: ChaseLog, i: int) -> ChaseLog:
    """Matrix i's log of a bucket's."""
    return ChaseLog(vs=log.vs[i], taus=log.taus[i], row0=log.row0[i], n=log.n, b=log.b)


def _backtransform_bucket(refl, X: torch.Tensor, *, mode: str, group: int, backend: str) -> torch.Tensor:
    """X_A = Q X_T for a bucket, X (B, n, k).  ``mode="blocked"`` merges Q1
    per DBR block and applies Q2 sweep-major through ``backtransform_wy``;
    ``"scan"`` applies the logs and panels one by one (the oracle)."""
    kind, data = refl
    if kind == "direct":
        with span("q1", X):
            return apply_q_direct(data, X)
    Q1, log = data
    with span("q2", X):
        if mode == "blocked":
            X = apply_q2_blocked_many(log, X, group=group or None, backend=backend)
        else:
            X = torch.stack(map_lanes(lambda i: apply_q2(_lane_log(log, i), X[i]), range(X.shape[0]), X))
    with span("q1", X):
        return apply_q_left_blocked(Q1, X) if mode == "blocked" else apply_q_left(Q1, X)


def _execute_bucket(A: torch.Tensor, pl: EvdPlan, eigenvectors: bool):
    """The executor, on a stack A (B, n, n): ``(w (B, k), V (B, n, k))`` or
    ``w``; in a span ``solve``, each chunk in a span ``chunk``."""
    with span("solve", A):
        chunk = bucket_chunk(pl.n)
        if A.shape[0] <= chunk:
            return _execute_chunk(A, pl, eigenvectors)
        full = A.shape[0] // chunk
        outs = map_lanes(lambda i: _execute_chunk(A[i * chunk : (i + 1) * chunk], pl, eigenvectors),
                         range(full), A)
        if A.shape[0] > full * chunk:
            outs.append(_execute_chunk(A[full * chunk :], pl, eigenvectors))
        if not eigenvectors:
            return torch.cat(outs)
        return torch.cat([w for w, _ in outs]), torch.cat([V for _, V in outs])


def _execute_chunk(A: torch.Tensor, pl: EvdPlan, eigenvectors: bool):
    """:func:`_execute_bucket` on a bucket of at most ``bucket_chunk(n)``
    matrices."""
    with span("chunk", A):
        start, count = pl.spectrum_range
        # Each matrix is scaled by the power of 2 at or above its largest entry
        # (exact), and its eigenvalues scaled back: the Householder norms and the
        # pivots square entries, which in float32 underflow below max|A| ~ 1e-16
        # (Shampoo's statistics of clipped gradients reach that).
        A = 0.5 * (A + A.mT)
        scale = torch.ldexp(torch.ones_like(A[..., 0, 0]), torch.frexp(A.abs().amax((-2, -1)))[1])
        A = A / scale[..., None, None]
        if pl.method == "jacobi":
            with span("jacobi", A):
                w, V = jacobi_eigh(A, max_sweeps=pl.config.max_sweeps)
            w = w[..., start : start + count] * scale[..., None]
            return (w, V[..., start : start + count]) if eigenvectors else w
        mode = pl.config.backtransform if pl.method == "two_stage" else "scan"
        out = _tridiag_bucket(
            A, b=pl.b, nb=pl.nb, method=pl.method, chase=pl.config.chase, tridiag=pl.tridiag,
            backend=pl.backend, return_reflectors=eigenvectors,
        )
        d, e = out[:2]
        with span("bisection", d):
            w = eigvalsh_tridiag_range(d, e, start=start, count=count, max_iter=pl.bisect_iters)
        if not eigenvectors:
            return w * scale[..., None]
        # Partial spectrum: one inverse-iteration lane per selected eigenvalue,
        # so the eigenvector phase costs O(k), not O(n).
        with span("inverse_iteration", d):
            VT = eigvecs_inverse_iteration(d, e, w)
        V = _backtransform_bucket(out[2], VT, mode=mode, group=pl.bt_group, backend=pl.backend)
        return w * scale[..., None], V


def _execute(A: torch.Tensor, pl: EvdPlan, eigenvectors: bool):
    """One matrix (n, n): the bucket executor on a bucket of one."""
    out = _execute_bucket(A[None], pl, eigenvectors)
    return (out[0][0], out[1][0]) if eigenvectors else out[0]


# Rayleigh-Ritz stops when the off-diagonal of V^T A V is below 1e-10 of
# its norm: an off-diagonal d moves w^-1/4 by ~d / (4 (w + ridge)), which
# at the root's ridge of 1e-6 max|w| is below 1e-4.
_RITZ_TOL = 1e-10
_RITZ_SWEEPS = 8


def _rayleigh_ritz(A: torch.Tensor, V: torch.Tensor):
    """Ritz values and vectors of symmetric ``A`` (..., n, n) on the span of
    ``V`` (..., n, n), in float64: C = V^T A V diagonalized by the port's
    Jacobi (C is diagonal but for clusters, so it converges in a few
    sweeps).  Returns (theta ascending (..., n), V Y)."""
    Vd = V.to(torch.float64)
    C = Vd.mT @ (A.to(torch.float64) @ Vd)
    C = 0.5 * (C + C.mT)
    n = C.shape[-1]
    if n % 2:  # Jacobi pairs indices: one decoupled entry above the spectrum
        top = torch.diagonal(C, dim1=-2, dim2=-1).amax(-1) + torch.linalg.norm(C, dim=(-2, -1)) + 1.0
        C = torch.nn.functional.pad(C, (0, 1, 0, 1))
        C[..., n, n] = top
    theta, Y = jacobi_eigh(C, max_sweeps=_RITZ_SWEEPS, tol=_RITZ_TOL)
    return theta[..., :n], Vd @ Y[..., :n, :n]


def _roots_from_window(A: torch.Tensor, V: torch.Tensor, p: int, eps: float) -> torch.Tensor:
    """A^{-1/p} per matrix from eigenvectors ``V`` (..., n, n) of symmetric
    ``A``: V root(theta) V^T with the Ritz values theta of a Rayleigh-Ritz
    step on V (float64), clamped at 0, ridged by ``eps * max(theta)`` and
    raised to ``-1/p``; returned in A's dtype.

    The Rayleigh-Ritz step is the port's own: inverse iteration cannot tell
    apart the vectors of a cluster, and a Shampoo statistics block has a
    hundred eigenvalues within a few ulps of 0, where the root's ridge
    makes ``w^-1/p`` vary most.  Pairing bisection's eigenvalues with those
    vectors put the roots tens of percent off; the Ritz pairs are
    consistent, so the root is as good as A and V's span."""
    with span("ritz_root", A):
        theta, V = _rayleigh_ritz(A, V)
        wmax = torch.clamp(theta.amax(-1), min=0.0)
        ridge = eps * torch.clamp(wmax, min=1e-30)
        root = torch.pow(torch.clamp(theta, min=0.0) + ridge[..., None], -1.0 / p)
        return ((V * root[..., None, :]) @ V.mT).to(A.dtype)


def tridiagonalize(
    A: torch.Tensor,
    *,
    b: Optional[int] = None,
    nb: Optional[int] = None,
    method: str = "two_stage",
    chase: str = "wavefront",
    return_reflectors: bool = False,
):
    """Symmetric A (n, n) -> ``(d, e)`` or ``(d, e, data)``, blocking from
    the table of A's device.  ``data`` is ``("direct", DirectReflectors)``
    or ``("two_stage", (BandReflectors, ChaseLog))``; in a span
    ``tridiagonalize``."""
    if method not in ("two_stage", "direct"):
        raise ValueError(f"unknown tridiagonalization method: {method}")
    with span("tridiagonalize", A):
        if method == "two_stage":
            dec = resolve_blocking(A.shape[-1], b=b, nb=nb, device_type=A.device.type)
            b, nb = dec.b, dec.nb
            method = "direct" if b <= 1 else method
        out = _tridiag_bucket(
            A[None], b=b, nb=nb, method=method, chase=chase, tridiag=None, backend=None,
            return_reflectors=return_reflectors,
        )
        d, e = out[0][0], out[1][0]
        if not return_reflectors:
            return d, e
        kind, data = out[2]
        if kind == "direct":
            return d, e, (kind, type(data)(*(t[0] for t in data)))
        refl, log = data
        refl = BandReflectors(V=refl.V[0], T=refl.T[0], b=refl.b, blocks=refl.blocks)
        return d, e, (kind, (refl, _lane_log(log, 0)))
