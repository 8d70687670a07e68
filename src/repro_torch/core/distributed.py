"""Distributed EVD building blocks (port of ``repro.core.distributed``).

The paper targets one accelerator; its future-work section calls out
scaling to clusters.  Two regimes:

1. **One huge matrix.**  The DBR trailing update ``A <- A - Z Y^T - Y Z^T``
   is row-parallel: each rank owns a block of rows of A, Y and Z (tall and
   skinny, k = nb << n) are replicated, and the update is two local GEMMs
   with no communication.  ``dist_trailing_update`` / ``dist_symm_matmul``
   are the two primitives, ``dist_band_reduce`` a band reduction built on
   them.
2. **Many medium matrices** (Shampoo's refresh): a batch of (n, n) blocks
   sharded over the flattened mesh, each rank running the whole solver on
   its slice.  That lives behind ``repro_torch.solver.solve_many(...,
   devices=(mesh, axes))``; ``sharded_eigh_batch`` / ``sharded_inverse_roots``
   are deprecated shims over it.

Multi-controller: every rank of the mesh calls each function with the same
arguments.  A plain tensor argument is the global, replicated value (a JAX
array without a sharding); a row-sharded ``A`` may also come as a
``DTensor`` with ``Shard(0)`` on ``mesh[axis]``.  Results are global on
every rank, except ``dist_trailing_update``'s, which JAX leaves sharded
over ``axis``: it is a ``DTensor`` and moves no bytes.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence

import torch

from repro_torch.backend import registry
from repro_torch.parallel.comm import all_gather_rows, axes_group, full_tensor
from repro_torch.solver import EvdConfig, solve_many

__all__ = [
    "dist_trailing_update",
    "dist_symm_matmul",
    "dist_band_reduce",
    "sharded_eigh_batch",
    "sharded_inverse_roots",
]


def _row_block(mesh, axis: str, X: torch.Tensor) -> torch.Tensor:
    """This rank's block of rows of ``X`` over ``axis``: the local shard of
    a row-sharded DTensor, or a slice of a replicated tensor."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(X, DTensor):
        if tuple(X.placements) != (Shard(0),) or X.device_mesh != mesh[axis]:
            raise ValueError(f"a DTensor operand must be Shard(0) on mesh[{axis!r}], got {X.placements}")
        return X.to_local()
    _, idx = axes_group(mesh, axis)
    ndev = mesh[axis].size()
    if X.shape[0] % ndev:
        raise ValueError(f"{X.shape[0]} rows do not split over the {ndev} ranks of axis {axis!r}")
    rows = X.shape[0] // ndev
    return X[idx * rows : (idx + 1) * rows]


def dist_trailing_update(mesh, axis: str, A: torch.Tensor, Y: torch.Tensor, Z: torch.Tensor):
    """``A - Z Y^T - Y Z^T`` with A row-sharded over ``axis``; Y, Z replicated.

    Each rank computes its row block ``a_blk - z_blk Y^T - y_blk Z^T`` by
    two local products, and the result is a ``DTensor`` sharded by rows
    over ``mesh[axis]`` (JAX's ``out_specs=P(axis, None)``): zero bytes
    between ranks.
    """
    from torch.distributed.tensor import DTensor, Shard

    a_blk = _row_block(mesh, axis, A)
    _, idx = axes_group(mesh, axis)
    rows = a_blk.shape[0]
    y_blk, z_blk = Y[idx * rows : (idx + 1) * rows], Z[idx * rows : (idx + 1) * rows]
    block = a_blk - z_blk @ Y.T - y_blk @ Z.T
    return DTensor.from_local(block, mesh[axis], [Shard(0)], run_check=False)


def dist_symm_matmul(mesh, axis: str, A: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``A @ V`` with A row-sharded over ``axis``: a local product, then the
    row blocks gathered; the whole product on every rank."""
    group, _ = axes_group(mesh, axis)
    return all_gather_rows(_row_block(mesh, axis, A) @ V, group)


def dist_band_reduce(mesh, axis: str, A: torch.Tensor, b: int, nb: int, panel_qr_fn=None) -> torch.Tensor:
    """Distributed DBR band reduction of a replicated symmetric (n, n) ``A``.

    The panel QRs and the A @ V products run replicated on every rank
    (panels are (m, b), tiny next to the trailing matrix); each block's
    trailing update runs row-parallel through :func:`dist_trailing_update`
    and is gathered back (``comm.full_tensor``, an ``all_gather`` of the
    row blocks).
    Where the trailing side does not split over the axis (``(m - w) % ndev
    != 0`` or ``m - w < ndev``) it runs locally on the ``trailing_update`` op's torch backend, as JAX pins
    its jnp one.  The algebra is ``repro.core.distributed.dist_band_reduce``'s
    line for line (see ``band_reduction._reduce_block``); ``panel_qr_fn``
    defaults to ``panel_qr_geqrf``.  Returns the band matrix, on every rank.
    """
    from .panel_qr import panel_qr_geqrf

    panel_qr_fn = panel_qr_fn or panel_qr_geqrf
    n = A.shape[0]
    if n % b or nb % b:
        raise ValueError("n and nb must be multiples of b")
    dtype, dev = A.dtype, A.device
    n_dev = mesh[axis].size()

    B = A.clone()
    ci = 0
    while n - ci > b:
        m = n - ci
        w = min(nb, m - b)
        q = w // b
        view = B[ci:, ci:]
        Vbuf = torch.zeros((m, w), dtype=dtype, device=dev)
        Zbuf = torch.zeros((m, w), dtype=dtype, device=dev)
        F = torch.zeros((m, w), dtype=dtype, device=dev)
        rows = torch.arange(m, device=dev)[:, None]
        for j in range(q):
            c0 = j * b
            r0 = c0 + b
            Pn = view[:, c0 : c0 + b]
            if j > 0:
                Pn = Pn - Zbuf[:, :c0] @ Vbuf[c0 : c0 + b, :c0].T - Vbuf[:, :c0] @ Zbuf[c0 : c0 + b, :c0].T
            V_j, T_j, _t, R_j = panel_qr_fn(Pn[r0:, :])
            Vhat = torch.zeros((m, b), dtype=dtype, device=dev)
            Vhat[r0:] = V_j
            fcol = torch.zeros((m, b), dtype=dtype, device=dev)
            fcol[:r0] = Pn[:r0]
            fcol[r0 : r0 + b] = R_j[:b]
            in_band = rows >= (c0 + torch.arange(b, device=dev)[None, :]) - b
            F[:, c0 : c0 + b] = torch.where(in_band, fcol, 0.0)
            M = view @ Vhat
            if j > 0:
                M = M - Zbuf[:, :c0] @ (Vbuf[:, :c0].T @ Vhat) - Vbuf[:, :c0] @ (Zbuf[:, :c0].T @ Vhat)
            MT = M @ T_j
            Z_j = MT - 0.5 * Vhat @ (T_j.T @ (Vhat.T @ MT))
            Vbuf[:, c0 : c0 + b] = Vhat
            Zbuf[:, c0 : c0 + b] = Z_j
        if (m - w) % n_dev == 0 and (m - w) >= n_dev:
            trailing = full_tensor(dist_trailing_update(mesh, axis, view[w:, w:], Vbuf[w:, :], Zbuf[w:, :]))
        else:  # the trailing side does not split over the ranks: run it locally
            trailing = registry.resolve("trailing_update", "torch")(view[w:, w:], Vbuf[w:, :], Zbuf[w:, :])
        view[w:, w:] = trailing
        view[:, :w] = F
        view[:w, w:] = F[w:, :].T
        ci += w
    return B


def _legacy_config(config: Optional[EvdConfig], eigh_kw: dict) -> EvdConfig:
    # Transitional: the historical b= / nb= / method= keywords fold into a
    # config, so every per-device solve goes through one plan.
    if config is not None:
        if eigh_kw:
            raise ValueError(f"pass either config= or legacy kwargs, not both: {eigh_kw}")
        return config
    return EvdConfig(**eigh_kw) if eigh_kw else EvdConfig()


def _deprecated(old: str) -> None:
    warnings.warn(
        f"repro_torch.core.distributed.{old} is a deprecated shim; call "
        f"repro_torch.solver.solve_many(..., devices=(mesh, axes)) instead",
        DeprecationWarning,
        stacklevel=3,
    )


def sharded_eigh_batch(mesh, axes: Sequence[str], A_batch: torch.Tensor, *,
                       config: Optional[EvdConfig] = None, **eigh_kw):
    """Deprecated shim over :func:`repro_torch.solver.solve_many`: eigh of a
    (B, n, n) batch sharded over the mesh axes, each rank solving its slice
    (``solve_many`` pads B with identity lanes to a multiple of the ranks)."""
    _deprecated("sharded_eigh_batch")
    cfg = _legacy_config(config, eigh_kw)
    return solve_many(A_batch, cfg, devices=(mesh, tuple(axes)))


def sharded_inverse_roots(mesh, axes: Sequence[str], A_batch: torch.Tensor, p: int, *, eps: float = 1e-6,
                          config: Optional[EvdConfig] = None, **eigh_kw):
    """Deprecated shim: batched A^{-1/p} sharded over the mesh axes, now
    ``solve_many(A, cfg, op="inverse_pth_root", devices=(mesh, axes))``."""
    _deprecated("sharded_inverse_roots")
    cfg = _legacy_config(config, eigh_kw)
    return solve_many(A_batch, cfg, op="inverse_pth_root", p=p, eps=eps, devices=(mesh, tuple(axes)))
