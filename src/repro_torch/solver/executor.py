"""``solve_many``: the one front door for every multi-matrix EVD consumer.

Port of ``repro.solver.executor``:

    from repro_torch.solver import EvdConfig, PadPolicy, solve_many

    results = solve_many([A32, A48, B32], EvdConfig())   # [(w, V), ...]
    w, V = solve_many(As, EvdConfig())                   # As: (B, n, n)
    X = solve_many(stats, cfg, op="inverse_pth_root", p=4)   # Shampoo

Input is a tree of list, tuple and dict nodes whose leaves are tensors (or
numpy arrays) with trailing square (n, n) shapes; leading leaf dimensions
are batch dimensions.  Matrices are grouped into buckets by (padded) size
and dtype under a :class:`PadPolicy`, each bucket runs as one cached
:class:`BatchPlan` execution, and the results are scattered back into the
input structure.

Device: tensor leaves run on the device they lie on (all on one device;
mixed devices raise).  Numpy leaves go to ``device``, default ``"cuda"``,
which raises without a card: pass ``device="cpu"`` for the plain versions.

``devices=`` shards every bucket's batch over the ranks of a mesh
(``torch.distributed``; every rank calls ``solve_many`` with the same
arguments): each rank solves its slice and the slices are gathered, so
every rank gets the whole result, bit for bit the same.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.backend import probe
from repro_torch.backend.compat import make_mesh
from repro_torch.parallel.comm import all_gather_rows, axes_group

from .batch import PadPolicy, batch_plan
from .config import EvdConfig, Spectrum
from .plan import _dtype_name, _roots_from_window

__all__ = ["solve_many"]

_OPS = ("eigh", "eigvals", "inverse_pth_root")


def _flatten(tree, leaves: List[Any]) -> Callable:
    """Append the leaves of ``tree`` (list, tuple and dict nodes; ``None``
    is an empty node) to ``leaves``; return a function that rebuilds the
    tree from an iterator over one result per leaf."""
    if tree is None:
        return lambda it: None
    if isinstance(tree, dict):
        subs = [(k, _flatten(v, leaves)) for k, v in tree.items()]
        return lambda it: type(tree)((k, f(it)) for k, f in subs)
    if isinstance(tree, (list, tuple)):
        subs = [_flatten(v, leaves) for v in tree]
        if hasattr(tree, "_fields"):  # a namedtuple
            return lambda it: type(tree)(*(f(it) for f in subs))
        return lambda it: type(tree)(f(it) for f in subs)
    leaves.append(tree)
    return lambda it: next(it)


def _common_device(leaves, device) -> torch.device:
    """The device every leaf runs on; see the module docstring."""
    on = {probe.resolve_device(t.device) for t in leaves if isinstance(t, torch.Tensor)}
    if len(on) > 1:
        raise ValueError(f"solve_many leaves lie on several devices {sorted(map(str, on))}; "
                         "move them to one")
    if device is not None:
        dev = probe.resolve_device(device)
        if on and on != {dev}:
            raise ValueError(f"solve_many leaves lie on {next(iter(on))}, device={dev} asked")
        return dev
    return next(iter(on)) if on else probe.resolve_device(None)


def _normalize_devices(devices):
    """``(mesh, axes)`` from a ``DeviceMesh`` (all its dimensions), a
    ``(mesh, axes)`` pair, or a flat sequence of devices, one per rank of
    the initialized world (this rank's entry its own device), which becomes
    a 1-D mesh named ``"solve_many"``."""
    from torch.distributed.device_mesh import DeviceMesh

    if devices is None:
        return None
    if isinstance(devices, DeviceMesh):
        return devices, tuple(devices.mesh_dim_names or ())
    if isinstance(devices, (tuple, list)) and len(devices) == 2 and isinstance(devices[0], DeviceMesh):
        mesh, axes = devices
        return mesh, ((axes,) if isinstance(axes, str) else tuple(axes))
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("devices= was an empty sequence")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "solve_many(devices=<a device sequence>) shards over the ranks of an initialized "
            "torch.distributed process group, one device a rank; none is initialized"
        )
    if len(devs) != dist.get_world_size():
        raise ValueError(f"devices= names {len(devs)} devices for a world of {dist.get_world_size()} ranks")
    own = probe.resolve_device(devs[dist.get_rank()])
    return make_mesh((len(devs),), ("solve_many",), device_type=own.type), ("solve_many",)


def _embed(X: torch.Tensor, N: int, ridge: float) -> torch.Tensor:
    """Embed a (m, n, n) stack into (m, N, N) as blockdiag(A, fill * I).

    The fill sits strictly above each matrix's Gershgorin upper bound, so
    the pad eigenvalues are the largest N - n of the padded spectrum and the
    real spectrum keeps its ascending positions [0, n).
    """
    n = X.shape[-1]
    if n == N:
        return X
    diag = torch.diagonal(X, dim1=-2, dim2=-1)
    offdiag = X.abs().sum(-1) - diag.abs()
    g_hi = (diag + offdiag).amax(-1)
    g_lo = (diag - offdiag).amin(-1)
    fill = g_hi + ridge * (1.0 + (g_hi - g_lo))
    out = fill[:, None, None] * torch.eye(N, dtype=X.dtype, device=X.device)
    out[:, :n, :n] = X
    return out


def _pad_batch(stack: torch.Tensor, target: int) -> torch.Tensor:
    """Append identity matrices so the bucket's batch reaches ``target``."""
    B, N = stack.shape[0], stack.shape[-1]
    if B == target:
        return stack
    eye = torch.eye(N, dtype=stack.dtype, device=stack.device).expand(target - B, N, N)
    return torch.cat([stack, eye])


def _run_bucket(stack: torch.Tensor, cfg: EvdConfig, op: str, p: int, eps: float, pad: PadPolicy, meshspec):
    """One shape bucket through one cached BatchPlan; with ``meshspec``
    each rank runs its slice of the batch (padded with identity lanes to a
    multiple of the ranks) and the slices are gathered."""
    B, N = stack.shape[0], stack.shape[-1]
    multiple = pad.batch_multiple
    if meshspec is not None:
        group, idx = axes_group(*meshspec)
        ndev = dist.get_world_size(group)
        multiple = math.lcm(multiple, ndev)
    stack = _pad_batch(stack, -(-B // multiple) * multiple)
    if meshspec is not None:
        per = stack.shape[0] // ndev
        stack = stack[idx * per : (idx + 1) * per]
    bpl = batch_plan(N, stack.shape[0], stack.dtype, cfg, device=stack.device)
    if op == "eigh":
        out = bpl(stack, donate=pad.donate)
    elif op == "eigvals":
        out = bpl.eigvals(stack, donate=pad.donate)
    else:
        out = bpl.inverse_pth_root(stack, p, eps=eps, donate=pad.donate)
    parts = out if op == "eigh" else (out,)
    if meshspec is not None:
        parts = tuple(all_gather_rows(t, group, "evd") for t in parts)
    parts = tuple(t[:B] for t in parts)
    return parts if op == "eigh" else parts[0]


def _empty_result(op: str, bshape, n: int, k: int, dtype, device):
    shapes = {"eigh": ((k,), (n, k)), "eigvals": ((k,),), "inverse_pth_root": ((n, n),)}[op]
    out = tuple(torch.zeros(tuple(bshape) + s, dtype=dtype, device=device) for s in shapes)
    return out if op == "eigh" else out[0]


def solve_many(
    mats: Any,
    config: EvdConfig = EvdConfig(),
    *,
    op: str = "eigh",
    eigenvectors: bool = True,
    p: int = 4,
    eps: float = 1e-6,
    pad: PadPolicy = PadPolicy(),
    devices=None,
    device: Optional[Union[str, torch.device]] = None,
):
    """Solve every symmetric matrix in ``mats`` under one ``config``.

    Each leaf is replaced by ``(w, V)`` (``op="eigh"``), ``w``
    (``op="eigvals"`` or ``eigenvectors=False``) or ``X``
    (``op="inverse_pth_root"``), with the leaf's batch dimensions kept.
    ``pad`` sets bucket sizes, the ridge-identity fill and batch padding
    (see :class:`PadPolicy`).  ``device`` places numpy leaves (default
    ``"cuda"``).

    ``devices=`` (a ``DeviceMesh``, a ``(mesh, axes)`` pair, or a sequence
    of devices, one per rank) shards every bucket's batch over the mesh's
    ranks: the batch is padded with identity lanes to a multiple of the
    rank count, each rank solves its slice, and the slices are gathered, so
    every rank returns the whole result.  Every rank must call with the
    same arguments.
    """
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {_OPS}")
    if op == "eigh" and not eigenvectors:
        op = "eigvals"
    if op == "inverse_pth_root" and not config.spectrum.is_full:
        raise ValueError(
            f"inverse_pth_root needs the full spectrum; config selects {config.spectrum}"
        )
    meshspec = _normalize_devices(devices)
    leaves: List[Any] = []
    rebuild = _flatten(mats, leaves)
    if not leaves:
        return rebuild(iter(()))
    dev = _common_device(leaves, device)

    infos = []
    for i, leaf in enumerate(leaves):
        leaf = torch.as_tensor(leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf), device=dev)
        if leaf.ndim < 2 or leaf.shape[-1] != leaf.shape[-2]:
            raise ValueError(
                f"solve_many leaf {i} must have a trailing square shape, got {tuple(leaf.shape)}"
            )
        n = leaf.shape[-1]
        infos.append(dict(leaf=leaf, batch_shape=tuple(leaf.shape[:-2]), n=n, N=pad.bucket_for(n),
                          count=math.prod(leaf.shape[:-2])))

    # Zero-size leaves ((0, n, n) stacks) get empty results directly.
    buckets: Dict[Tuple[int, str], List[int]] = {}
    results: List[Any] = [None] * len(leaves)
    for i, info in enumerate(infos):
        if info["count"] == 0:
            _, k = config.spectrum.index_range(info["n"])
            results[i] = _empty_result(op, info["batch_shape"], info["n"], k, info["leaf"].dtype, dev)
            continue
        buckets.setdefault((info["N"], _dtype_name(info["leaf"].dtype)), []).append(i)

    for (N, _), leaf_ids in buckets.items():
        padded = any(infos[i]["n"] != N for i in leaf_ids)
        # A padded bucket mixes real sizes, so it computes the full padded
        # spectrum and the scatter slices each matrix's window out of
        # positions [0, n).  Padded inverse roots go through eigh and are
        # rebuilt from the real window: the pad block is an exactly
        # degenerate cluster whose inverse-iteration columns are unreliable,
        # so they are dropped before V root(w) V^T is formed.
        cfg = config.replace(spectrum=Spectrum.all()) if padded else config
        exec_op = "eigh" if (padded and op == "inverse_pth_root") else op
        raw = [infos[i]["leaf"].reshape((-1,) + infos[i]["leaf"].shape[-2:]) for i in leaf_ids]
        segs = [_embed(s, N, pad.ridge) for s in raw] if padded else raw
        stack = segs[0] if len(segs) == 1 else torch.cat(segs)
        out = _run_bucket(stack, cfg, exec_op, p, eps, pad, meshspec)

        off = 0
        for i, A_i in zip(leaf_ids, raw):
            n, m, bshape = infos[i]["n"], infos[i]["count"], infos[i]["batch_shape"]
            start, count = config.spectrum.index_range(n)
            if op == "eigh":
                w, V = out[0][off : off + m], out[1][off : off + m]
                if padded:
                    w, V = w[:, start : start + count], V[:, :n, start : start + count]
                results[i] = (w.reshape(bshape + w.shape[1:]), V.reshape(bshape + V.shape[1:]))
            elif op == "eigvals":
                w = out[off : off + m]
                if padded:
                    w = w[:, start : start + count]
                results[i] = w.reshape(bshape + w.shape[1:])
            else:
                if padded:
                    V = out[1][off : off + m]
                    X = _roots_from_window(0.5 * (A_i + A_i.mT), V[:, :n, :n], p, eps)
                else:
                    X = out[off : off + m]
                results[i] = X.reshape(bshape + X.shape[1:])
            off += m
    return rebuild(iter(results))
