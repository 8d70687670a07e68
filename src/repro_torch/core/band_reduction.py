"""Band reduction: dense symmetric -> banded symmetric (the paper's DBR).

Port of ``repro.core.band_reduction``.  The static :class:`StageSchedule`
walks the matrix in blocks of ``w = nb`` columns; each block is q = w/b
compensated panel QRs plus one rank-2w trailing update, run as

* ``mode="fused"``: one ``fused_panel_update`` registry op (kernel A);
* ``mode="unfused"``: the legacy composition :func:`_reduce_block`, a
  panel QR per panel (``panel_method``) and one ``trailing_update``
  registry op (kernel D) per block.

The port works on its own copy of A and updates each trailing view
``B[ci:, ci:]`` in place (the JAX package rebuilds B functionally).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.backend import registry

from .panel_qr import resolve_panel_qr

__all__ = [
    "band_reduce",
    "BandReflectors",
    "StageEntry",
    "StageSchedule",
    "build_stage_schedule",
    "apply_q_left",
    "form_q",
]


@dataclasses.dataclass
class BandReflectors:
    """Householder data of the band reduction's orthogonal factor Q1.

    A = Q1 B Q1^T with Q1 = H_1 ... H_P (one block reflector per panel).
    ``V`` (n, P*b) unit-lower-trapezoidal panels in full-matrix coordinates,
    ``T`` (P, b, b) compact-WY factors, ``blocks`` the DBR block structure
    ((panel0, q), ...), ``Tm`` the optional per-block merged T factors.
    """

    V: torch.Tensor
    T: torch.Tensor
    b: int
    blocks: Tuple[Tuple[int, int], ...] = ()
    Tm: Optional[Tuple[torch.Tensor, ...]] = None


@dataclasses.dataclass(frozen=True)
class StageEntry:
    """One block step: start column ``ci``, trailing side ``m``, factored
    columns ``w`` (= q·b), and the block's panels ``panel0 .. panel0+q-1``."""

    ci: int
    m: int
    w: int
    panel0: int
    q: int


@dataclasses.dataclass(frozen=True)
class StageSchedule:
    """The static first-stage schedule (depends only on n, b, nb)."""

    n: int
    b: int
    nb: int
    entries: Tuple[StageEntry, ...]

    @property
    def num_panels(self) -> int:
        return sum(e.q for e in self.entries)

    @property
    def blocks(self) -> Tuple[Tuple[int, int], ...]:
        return tuple((e.panel0, e.q) for e in self.entries)


def build_stage_schedule(n: int, b: int, nb: int) -> StageSchedule:
    """The static block schedule of ``band_reduce`` for sizes (n, b, nb)."""
    entries = []
    ci = 0
    p = 0
    while n - ci > b:
        m = n - ci
        w = min(nb, m - b)
        q = w // b
        entries.append(StageEntry(ci=ci, m=m, w=w, panel0=p, q=q))
        p += q
        ci += w
    return StageSchedule(n=n, b=b, nb=nb, entries=tuple(entries))


def _reduce_block(
    Bv: torch.Tensor, b: int, w: int, panel_qr_fn: Callable, syr2k_update: Callable
):
    """Reduce the first ``w`` columns of the trailing view ``Bv`` ([B,] m, m)
    to bandwidth ``b`` and apply one rank-2w trailing update.

    Returns ``(new_view, Vbuf ([B,] m, w), Ts ([B,] w//b, b, b))``; ``Bv``
    is not modified.
    """
    m = Bv.shape[-1]
    lead = tuple(Bv.shape[:-2])
    q = w // b
    dtype, dev = Bv.dtype, Bv.device
    Vbuf = torch.zeros(lead + (m, w), dtype=dtype, device=dev)
    Zbuf = torch.zeros(lead + (m, w), dtype=dtype, device=dev)
    F = torch.zeros(lead + (m, w), dtype=dtype, device=dev)
    Ts = []
    rows = torch.arange(m, device=dev)[:, None]
    for j in range(q):
        c0 = j * b
        r0 = c0 + b
        P = Bv[..., :, c0 : c0 + b]
        if j > 0:
            P = (P - Zbuf[..., :, :c0] @ Vbuf[..., c0 : c0 + b, :c0].mT
                 - Vbuf[..., :, :c0] @ Zbuf[..., c0 : c0 + b, :c0].mT)
        V_j, T_j, _taus, R_j = panel_qr_fn(P[..., r0:, :])
        Vhat = torch.zeros(lead + (m, b), dtype=dtype, device=dev)
        Vhat[..., r0:, :] = V_j
        fcol = torch.zeros(lead + (m, b), dtype=dtype, device=dev)
        fcol[..., :r0, :] = P[..., :r0, :]
        fcol[..., r0 : r0 + b, :] = R_j
        in_band = rows >= (c0 + torch.arange(b, device=dev)[None, :]) - b
        F[..., :, c0 : c0 + b] = torch.where(in_band, fcol, 0.0)
        M = Bv @ Vhat
        if j > 0:
            M = (M - Zbuf[..., :, :c0] @ (Vbuf[..., :, :c0].mT @ Vhat)
                 - Vbuf[..., :, :c0] @ (Zbuf[..., :, :c0].mT @ Vhat))
        MT = M @ T_j
        Z_j = MT - 0.5 * Vhat @ (T_j.mT @ (Vhat.mT @ MT))
        Vbuf[..., :, c0 : c0 + b] = Vhat
        Zbuf[..., :, c0 : c0 + b] = Z_j
        Ts.append(T_j)
    new_view = Bv.clone()
    new_view[..., w:, w:] = syr2k_update(Bv[..., w:, w:], Vbuf[..., w:, :], Zbuf[..., w:, :])
    new_view[..., :, :w] = F
    new_view[..., :w, w:] = F[..., w:, :].mT
    return new_view, Vbuf, torch.stack(Ts, dim=-3)


def band_reduce(
    A: torch.Tensor,
    b: int,
    nb: Optional[int] = None,
    *,
    panel_method: str = "geqrf",
    syr2k_update: Optional[Callable] = None,
    return_reflectors: bool = False,
    merge_ts: bool = False,
    mode: Optional[str] = None,
    backend: Optional[str] = None,
):
    """Reduce a symmetric (n, n) matrix, or a bucket of them (B, n, n), to
    band form with bandwidth ``b``.

    A bucket walks the static schedule once: one op call per DBR block for
    the whole bucket (the calls ``jax.vmap`` makes of the Pallas kernels).
    ``nb`` (a multiple of ``b``, default ``b``) is the DBR update block.
    ``backend`` picks the registry ops' implementations (default: ``cuda``
    for a CUDA tensor, ``torch`` on the CPU).

    ``mode`` is ``"fused"`` or ``"unfused"`` (default: the process-wide
    ``registry.default_tridiag()``, ``"fused"`` unless the env var says
    otherwise).  The unfused
    composition takes ``panel_method``: ``"geqrf"`` (``panel_qr_geqrf``),
    ``"householder"`` (``panel_qr_householder``) or ``"kernel"`` (the
    ``panel_qr`` op on ``backend``: kernel E on ``cuda``; JAX names it
    ``"pallas"``), and ``syr2k_update``, a callable ``(C, Y, Z) ->
    C - Z Y^T - Y Z^T`` (default: the ``trailing_update`` op on
    ``backend``).  Injecting either implies ``"unfused"``, and asking for
    ``"fused"`` beside them raises ``ValueError``, as in the JAX package.
    Kernel E factors one panel a call, so a bucket with ``"kernel"`` raises
    ``ValueError`` too (no batched solve reaches it).

    ``A`` is not modified; the fused mode reads only its lower triangle (an
    A symmetric only to rounding is taken as its lower triangle and that
    triangle's mirror).  Returns ``Bband`` and, with
    ``return_reflectors``, the :class:`BandReflectors` of Q1 (``merge_ts``
    also fills ``Tm``), with A's leading dimension.
    """
    n = A.shape[-1]
    lead = tuple(A.shape[:-2])
    nb = b if nb is None else nb
    if n % b != 0:
        raise ValueError(f"n={n} must be a multiple of b={b}")
    if nb % b != 0:
        raise ValueError(f"nb={nb} must be a multiple of b={b}")
    custom_phases = syr2k_update is not None or panel_method != "geqrf"
    if mode is None:
        mode = "unfused" if custom_phases else registry.default_tridiag()
    if mode not in ("fused", "unfused"):
        raise ValueError(f"unknown band-reduction mode: {mode!r}")
    if mode == "fused" and custom_phases:
        raise ValueError(
            "mode='fused' executes panel QR and the trailing update as one "
            "op; syr2k_update/panel_method injection requires mode='unfused'"
        )
    if panel_method == "kernel" and lead:
        raise ValueError("panel_method='kernel' (kernel E) takes one matrix, not a bucket")
    backend = backend or registry.default_backend(A.device)
    if mode == "fused":
        fused_update = registry.resolve("fused_panel_update", backend)
    else:
        panel_qr_fn = resolve_panel_qr(panel_method, backend)
        syr2k_update = syr2k_update or registry.resolve("trailing_update", backend)

    if mode == "fused":
        # Kernel A's GEMV reads only the lower triangle of the view it is
        # given and relies on the view being symmetric bit for bit: the
        # matrix reduced is A's lower triangle and its mirror.
        B = A.tril().contiguous()
        B += A.tril(-1).mT
    else:
        B = A.contiguous().clone()
    schedule = build_stage_schedule(n, b, nb)
    p = schedule.num_panels
    Vall = torch.zeros(lead + (n, p * b), dtype=A.dtype, device=A.device)
    Tall = torch.zeros(lead + (p, b, b), dtype=A.dtype, device=A.device)
    for e in schedule.entries:
        view = B[..., e.ci :, e.ci :]
        if mode == "fused":
            _, Vbuf, Ts = fused_update(view, b, e.w)
        else:
            new_view, Vbuf, Ts = _reduce_block(view, b, e.w, panel_qr_fn, syr2k_update)
            view.copy_(new_view)
        Vall[..., e.ci :, e.panel0 * b : (e.panel0 + e.q) * b] = Vbuf
        Tall[..., e.panel0 : e.panel0 + e.q, :, :] = Ts
    if not return_reflectors:
        return B
    refl = BandReflectors(V=Vall, T=Tall, b=b, blocks=schedule.blocks)
    if merge_ts:
        from .backtransform import merge_band_reflectors

        refl = merge_band_reflectors(refl)
    return B, refl


def apply_q_left(refl: BandReflectors, X: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """Q1 @ X (or Q1^T @ X), one rank-b update per panel; leading batch
    dimensions of ``refl`` and ``X`` broadcast."""
    b = refl.b
    P = refl.T.shape[-3]
    order = range(P) if transpose else range(P - 1, -1, -1)
    for p in order:
        V = refl.V[..., :, p * b : (p + 1) * b]
        Tp = refl.T[..., p, :, :].mT if transpose else refl.T[..., p, :, :]
        X = X - V @ (Tp @ (V.mT @ X))
    return X


def form_q(refl: BandReflectors, n: int) -> torch.Tensor:
    """The dense orthogonal factor Q1 (n, n)."""
    return apply_q_left(refl, torch.eye(n, dtype=refl.V.dtype, device=refl.V.device))
