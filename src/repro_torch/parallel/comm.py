"""The one place the port talks to ``torch.distributed``.

The port's multi-device code is multi-controller: one process per rank,
every rank calling the same function on the same arguments, which is how a
``shard_map`` program of the JAX package reads in PyTorch.  This module
holds what those functions need from the process group:

* :func:`axes_group` — the process group over one or several axes of a
  ``DeviceMesh`` and this rank's linear index over them (row-major in the
  order the axes are given, as ``jax.lax.axis_index`` over a tuple of axes
  counts).
* :func:`all_gather_rows` / :func:`all_reduce_sum` — the two plain
  collectives (the gather counted in :data:`traffic`), and
  :func:`full_tensor`, a sharded DTensor made whole.
* The collectives of a sharded train step, each a ``torch.autograd.Function``
  over the group of some mesh axes (:func:`axes_group`), in Megatron's
  pairs: :func:`all_reduce` (sum forward, identity backward: *g*) and
  :func:`copy_to` (identity forward, sum backward: *f*); :func:`all_gather`
  along any dim (its backward a reduce-scatter, or the rank's own slice)
  and its reverse :func:`reduce_scatter`; :func:`split` (the own slice,
  gathered back in the backward); and :func:`all_reduce_max`, without a
  gradient.  Sums run in float32 (float64 for a float64 tensor), then
  cast back.  A dim that the group does not divide is split as GSPMD pads
  it: ``ceil(n / k)`` rows a rank, the last ranks short
  (:func:`chunk_bounds`).  :data:`traffic` counts the bytes each call
  moved, by tag, and :data:`kinds` by kind and group.
* :func:`run_ranks` — run a function on ``world_size`` fresh processes, the
  counterpart of JAX's ``--xla_force_host_platform_device_count`` (the
  tests and ``chip_smoke.py`` use it).

**Gloo and CUDA tensors.**  Several ranks that share one card cannot use
NCCL (it refuses two ranks on one device), so they use the gloo backend.
Gloo's c10d collectives take CUDA tensors and copy them through host
memory themselves (``all_gather``, ``all_gather_into_tensor``,
``all_reduce`` and ``reduce_scatter_tensor``, checked on an H100 with
torch 2.11 by ``scripts/gloo_cuda_check.py``).
DTensor's own collectives do not: ``DTensor.full_tensor()`` goes through
the functional collectives, and on a gloo group with CUDA tensors its
``wait_tensor`` crashed the process (segmentation fault, torch 2.11 + CUDA
12.8 on an H100).  So :func:`full_tensor` gathers a sharded DTensor by c10d
``all_gather_into_tensor`` on every backend, as every gather here does
(one buffer for the group's rows: a list of 256 outputs cost the fake
backend of the dry-run 0.2 s a call): one path, the same bytes as
``DTensor.full_tensor()``.  DTensor is a container only: a rank's shard
and its placements, never the path data moves by.  :func:`reduce_scatter`
is ``reduce_scatter_tensor`` on every backend, an uneven split padded with
zero rows.
"""
from __future__ import annotations

import contextlib
import datetime
import faulthandler
import math
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.backend import trace

__all__ = [
    "axes_group",
    "all_gather_rows",
    "all_reduce_sum",
    "full_tensor",
    "all_reduce",
    "copy_to",
    "all_gather",
    "reduce_scatter",
    "split",
    "all_reduce_max",
    "chunk_bounds",
    "traffic",
    "kinds",
    "reset_traffic",
    "fake_world",
    "init_world",
    "run_ranks",
    "INIT_TIMEOUT_S",
]

# A rank that waits longer than this on a peer (rendezvous or collective)
# fails instead of hanging the caller.
INIT_TIMEOUT_S = 120
# After a rank fails, how long its peers get to report before they are stopped.
GRACE_S = 10

Axes = Union[str, Sequence[str]]

# Process groups over several mesh axes, per (world group, mesh, axes);
# ``new_group`` is collective, so every rank builds the same groups in the
# same order.
_groups: Dict[Tuple[Any, Any, Tuple[str, ...]], Tuple[Any, int]] = {}
# The mesh axes of each group this rank is in (for :data:`kinds`).
_group_axes: Dict[Any, Tuple[str, ...]] = {}


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axes_group(mesh, axes: Axes):
    """``(group, index)``: the process group of this rank's peers over the
    mesh axes ``axes`` (a name or a tuple of names) and this rank's linear
    index among them, row-major in the order of ``axes``.  One axis is the
    mesh's own group; several are flattened into one group, built once per
    ``(mesh, axes)`` on every rank."""
    axes = _axes(axes)
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axes if a not in names]
    if missing or len(set(axes)) != len(axes) or not axes:
        raise ValueError(f"axes {axes} must be distinct names of the mesh's dimensions {names}")
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
        _group_axes[group] = axes
        return group, mesh.get_local_rank(axes[0])
    key = (dist.group.WORLD, mesh, axes)
    if key not in _groups:
        with _disable_current_modes():  # not a step's work: out of a dry-run's fake tensors and count
            _groups[key] = _new_group(mesh, names, axes)
    return _groups[key]


def _new_group(mesh, names, axes):
    """The group of this rank's peers over several mesh axes, and its index in it."""
    dims = [names.index(a) for a in axes]
    rest = [d for d in range(len(names)) if d not in dims]
    size = math.prod(mesh.mesh.shape[d] for d in dims)
    rows = mesh.mesh.permute(*rest, *dims).reshape(-1, size).tolist()
    me = dist.get_rank()
    found = None
    for ranks in rows:  # every rank creates every group, in this order
        group = dist.new_group(ranks, backend=dist.get_backend())
        if me in ranks:
            found = (group, ranks.index(me))
            _group_axes[group] = axes
    if found is None:
        raise ValueError(f"rank {me} is not in the mesh {mesh}")
    return found


def all_gather_rows(x: torch.Tensor, group, tag: str = "rows") -> torch.Tensor:
    """Every rank's ``x`` (all of one shape), concatenated along dim 0 in
    the group's rank order; the same tensor on every rank.  Its bytes are
    counted under ``tag``."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    _count(tag, x, "all_gather", group)
    with trace.collective():
        dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, as a new tensor (the
    same bits on every rank)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    with trace.collective():
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def full_tensor(dt) -> torch.Tensor:
    """The whole value of a DTensor with ``Shard`` / ``Replicate``
    placements on a mesh of any rank, on every rank, gathered by c10d
    ``all_gather`` over each sharded mesh dimension (see the module
    docstring).  Shards must be equal."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = dt.device_mesh
    x = dt.to_local()
    names = mesh.mesh_dim_names or tuple(str(i) for i in range(mesh.ndim))
    for i in reversed(range(mesh.ndim)):  # the last mesh dim holds the innermost blocks
        pl = dt.placements[i]
        if isinstance(pl, Replicate):
            continue
        if not isinstance(pl, Shard) or x.shape[pl.dim] * mesh.size(i) > dt.shape[pl.dim]:
            raise ValueError(f"full_tensor takes Shard / Replicate placements of equal shards, got "
                             f"{dt.placements} of {tuple(dt.shape)} on {mesh}")
        group = mesh.get_group(i)
        _group_axes.setdefault(group, (names[i],))
        x = _gather(x, pl.dim, group, mesh.size(i), None, "param")
    if tuple(x.shape) != tuple(dt.shape):
        raise ValueError(f"full_tensor: shards of {tuple(dt.shape)} over {names} are not equal")
    return x


# ----------------------------------------------------------- step collectives
# Bytes each collective moved, by tag ("act": activations of tensor
# parallelism, "param": parameter gathers, "grad": gradient sums): the
# payload one rank hands the collective.
traffic: Dict[str, int] = {}
# The same calls by kind, then by the mesh axes of the group ("data",
# "model", or "pod+data" for a group over several): {"count", "bytes"}.
kinds: Dict[str, Dict[str, Dict[str, int]]] = {}


def reset_traffic() -> None:
    traffic.clear()
    kinds.clear()


def _count(tag: str, t: torch.Tensor, kind: str, group) -> None:
    n = t.numel() * t.element_size()
    traffic[tag] = traffic.get(tag, 0) + n
    rec = kinds.setdefault(kind, {}).setdefault("+".join(_group_axes.get(group, ("?",))), {"count": 0, "bytes": 0})
    rec["count"] += 1
    rec["bytes"] += n


def chunk_bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of ``n`` that part ``index`` of ``parts`` holds:
    ``ceil(n / parts)`` a part, the last parts short or empty."""
    c = -(-n // parts)
    return min(index * c, n), min((index + 1) * c, n)


def _wide(x: torch.Tensor) -> torch.dtype:
    """The dtype a reduction runs in: float32, or float64 for float64."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _sum(x: torch.Tensor, group, tag: str) -> torch.Tensor:
    """All-reduce sum in float32 (float64 for float64), cast back to
    ``x``'s dtype."""
    out = x.detach().to(_wide(x), memory_format=torch.contiguous_format, copy=True)
    _count(tag, out, "all_reduce", group)
    with trace.collective():
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.dtype)


def _gather(x: torch.Tensor, dim: int, group, k: int, length, tag: str) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group order; shards
    of ``ceil(length / k)`` rows, the last ones short, trimmed to ``length``.
    One ``all_gather_into_tensor`` into a buffer of the group's rows."""
    x = x.detach()
    n_loc = x.shape[dim]
    c = n_loc if length is None else -(-length // k)
    src = x.movedim(dim, 0)
    if n_loc < c:
        src = torch.cat([src, src.new_zeros((c - n_loc,) + tuple(src.shape[1:]))])
    src = src.contiguous()
    out = src.new_empty((k * c,) + tuple(src.shape[1:]))
    _count(tag, src, "all_gather", group)
    with trace.collective():
        dist.all_gather_into_tensor(out, src, group=group)
    # Contiguous, as a concatenation is: a permuted weight would send its
    # products to other GEMM kernels, which round bf16 otherwise.
    out = out.movedim(0, dim).contiguous()
    return out if length is None else out.narrow(dim, 0, length)


def _own(x: torch.Tensor, dim: int, k: int, index: int) -> torch.Tensor:
    lo, hi = chunk_bounds(x.shape[dim], k, index)
    return x.narrow(dim, lo, hi - lo)


def _reduce_scatter(x: torch.Tensor, dim: int, group, k: int, index: int, tag: str) -> torch.Tensor:
    """The sum over the group, and of it this rank's rows along ``dim``
    (:func:`chunk_bounds`); float32 inside, ``dim`` padded with zeros to
    ``k`` parts of ``ceil(n / k)`` rows."""
    n = x.shape[dim]
    c = -(-n // k)
    src = x.detach().to(_wide(x)).movedim(dim, 0)
    if n < k * c:
        src = torch.cat([src, src.new_zeros((k * c - n,) + tuple(src.shape[1:]))])
    src = src.contiguous()
    out = src.new_empty((c,) + tuple(src.shape[1:]))
    _count(tag, src, "reduce_scatter", group)
    with trace.collective():
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM, group=group)
    lo, hi = chunk_bounds(n, k, index)
    return out[:hi - lo].movedim(0, dim).to(x.dtype).contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        return _sum(x, group, tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, tag):
        ctx.group, ctx.tag = group, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group, ctx.tag), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, k, index, length, grad, tags):
        ctx.dim, ctx.group, ctx.k, ctx.index, ctx.grad, ctx.tag = dim, group, k, index, grad, tags[1]
        return _gather(x, dim, group, k, length, tags[0])

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = _reduce_scatter(g, ctx.dim, ctx.group, ctx.k, ctx.index, ctx.tag)
        else:
            g = _own(g, ctx.dim, ctx.k, ctx.index).contiguous()
        return g, None, None, None, None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, k, index, tag):
        ctx.dim, ctx.group, ctx.k, ctx.n, ctx.tag = dim, group, k, x.shape[dim], tag
        return _reduce_scatter(x, dim, group, k, index, tag)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group, ctx.k, ctx.n, ctx.tag), None, None, None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, k, index, tag):
        ctx.dim, ctx.group, ctx.k, ctx.n, ctx.tag = dim, group, k, x.shape[dim], tag
        return _own(x, dim, k, index).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group, ctx.k, ctx.n, ctx.tag), None, None, None, None, None


def _grp(mesh, axes):
    group, index = axes_group(mesh, axes)
    return group, dist.get_world_size(group), index


def all_reduce(x: torch.Tensor, mesh, axes: Axes, *, tag: str = "act") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes`` (float32 inside); the
    backward passes the gradient through (Megatron's *g*)."""
    return _AllReduce.apply(x, _grp(mesh, axes)[0], tag)


def copy_to(x: torch.Tensor, mesh, axes: Axes, *, tag: str = "act") -> torch.Tensor:
    """``x`` itself; the backward sums the gradient over the ranks of
    ``axes`` (Megatron's *f*): ``x`` feeds work split over them."""
    return _CopyTo.apply(x, _grp(mesh, axes)[0], tag)


def all_gather(x: torch.Tensor, mesh, axes: Axes, dim: int, *, length: int = None, grad: str = "sum",
               tags: Tuple[str, str] = ("act", "act")) -> torch.Tensor:
    """Every rank's ``x`` over ``axes`` concatenated along ``dim`` (``length``
    rows in all when the split is uneven).  The backward reduce-scatters
    (``grad="sum"``: each rank holds a partial gradient of the whole) or
    keeps the rank's own rows (``grad="slice"``: each holds all of it).
    ``tags`` tag the forward's and the backward's bytes."""
    if grad not in ("sum", "slice"):
        raise ValueError(f"grad must be 'sum' or 'slice', got {grad!r}")
    group, k, index = _grp(mesh, axes)
    return _AllGather.apply(x, dim % x.ndim, group, k, index, length, grad, tags)


def reduce_scatter(x: torch.Tensor, mesh, axes: Axes, dim: int, *, tag: str = "act") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axes``, and of it this rank's
    rows along ``dim`` (:func:`chunk_bounds`); the backward all-gathers."""
    group, k, index = _grp(mesh, axes)
    return _ReduceScatter.apply(x, dim % x.ndim, group, k, index, tag)


def split(x: torch.Tensor, mesh, axes: Axes, dim: int, *, tag: str = "act") -> torch.Tensor:
    """This rank's rows of ``x`` along ``dim`` over ``axes``
    (:func:`chunk_bounds`); the backward all-gathers."""
    group, k, index = _grp(mesh, axes)
    return _Split.apply(x, dim % x.ndim, group, k, index, tag)


def all_reduce_max(x: torch.Tensor, mesh, axes: Axes, *, tag: str = "act") -> torch.Tensor:
    """The elementwise max of ``x`` over the ranks of ``axes``, detached."""
    out = x.detach().to(_wide(x), memory_format=torch.contiguous_format, copy=True)
    group = _grp(mesh, axes)[0]
    _count(tag, out, "all_reduce_max", group)
    with trace.collective():
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out.to(x.dtype)


def init_world(device_type: str) -> bool:
    """Join the world this process was started in, if any; return whether
    one is initialized.  A world already initialized (``run_ranks``) is
    kept; otherwise ``torchrun``'s ``WORLD_SIZE`` / ``RANK`` (``env://``)
    start one when ``WORLD_SIZE`` > 1.  The backend is picked: NCCL when
    every rank of the host has a card of its own, gloo when ranks share a
    card or run on the CPU.  On CUDA, rank r takes card ``LOCAL_RANK %
    device_count``."""
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        torch.cuda.set_device(local % torch.cuda.device_count())
        backend = "nccl" if torch.cuda.device_count() >= per_host else "gloo"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://",
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
    return True


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a world of ``world_size`` ranks on c10d's
    ``fake`` backend: groups and meshes build as in the real world, and
    every collective returns at once without moving a byte (an output keeps
    whatever it held).  Code that runs inside counts what rank 0 of the real
    world would send (:data:`traffic`, :data:`kinds`).  On exit the group is
    destroyed and the cached groups forgotten.  Raises if a process group is
    already initialized."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
        _groups.clear()
        _group_axes.clear()


# ------------------------------------------------------------------ ranks
def _rank_main(fn, rank, world_size, backend, device_type, store, args, results) -> None:
    """Body of one spawned rank: join the group, run ``fn``, send back
    ``(rank, ok, pickled result or traceback)``."""
    faulthandler.enable()  # a rank that crashes prints its stack
    try:
        if device_type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S))
        try:
            out = fn(*args)
            if device_type != "cpu":
                torch.cuda.synchronize()
            results.put((rank, True, pickle.dumps(out)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world_size: int, *, backend: str, device_type: str, args: tuple = (),
              timeout_s: float = 900.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` new processes, one rank each,
    joined in one process group; return every rank's result, by rank.

    The processes start with the *spawn* method (CUDA cannot be set up
    again in a forked child), so ``fn`` must be a module-level function and
    ``args`` and the results picklable.  They meet through a ``file://``
    store in a new temporary directory (no port to collide on), with
    ``init_process_group``'s timeout at :data:`INIT_TIMEOUT_S`.  On the CPU
    each rank runs on one thread; on CUDA rank r takes device
    ``r % device_count`` (several ranks share a card over gloo; NCCL wants
    one rank a card).  If any rank raises, or dies, or the ranks take longer
    than ``timeout_s``, every rank is stopped and this raises with the
    ranks' tracebacks.
    """
    import torch.multiprocessing as mp

    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"device_type must be 'cpu' or 'cuda', got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks(device_type='cuda') needs a CUDA device")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: Dict[int, Any] = {}
    failed: Dict[int, str] = {}
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, backend, device_type, store, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(out) + len(failed) < world_size:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue_mod.Empty:
                    for r, p in enumerate(procs):  # died without a word (a crash)
                        if p.exitcode not in (None, 0) and r not in out and r not in failed:
                            failed[r] = f"exited with code {p.exitcode}"
                            deadline = min(deadline, time.monotonic() + GRACE_S)
                    if time.monotonic() > deadline:
                        for r in range(world_size):
                            if r not in out and r not in failed:
                                failed[r] = "did not finish" + ("" if failed else f" within {timeout_s} s")
                    continue
                if ok:
                    out[rank] = pickle.loads(payload)
                else:
                    failed[rank] = payload
                    # The peers of a failed rank fail in their collectives:
                    # wait a little for their reports, then stop them.
                    deadline = min(deadline, time.monotonic() + GRACE_S)
        finally:
            for p in procs:
                p.join(timeout=1 if failed else 30)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if failed:
        raise RuntimeError(f"run_ranks: {fn.__name__} failed on ranks {sorted(failed)} of {world_size}:\n"
                           + "\n".join(f"rank {r}: {msg}" for r, msg in sorted(failed.items())))
    return [out[r] for r in range(world_size)]
