"""The one place the port talks to ``torch.distributed``.

The port's multi-device code is multi-controller: one process per rank,
every rank calling the same function on the same arguments, which is how a
``shard_map`` program of the JAX package reads in PyTorch.  This module
holds what those functions need from the process group:

* :func:`axes_group` — the process group over one or several axes of a
  ``DeviceMesh`` and this rank's linear index over them (row-major in the
  order the axes are given, as ``jax.lax.axis_index`` over a tuple of axes
  counts).
* :func:`all_gather_rows` / :func:`all_reduce_sum` — the two collectives,
  and :func:`full_tensor`, a row-sharded DTensor made whole.
* :func:`run_ranks` — run a function on ``world_size`` fresh processes, the
  counterpart of JAX's ``--xla_force_host_platform_device_count`` (the
  tests and ``chip_smoke.py`` use it).

**Gloo and CUDA tensors.**  Several ranks that share one card cannot use
NCCL (it refuses two ranks on one device), so they use the gloo backend.
Gloo's c10d collectives take CUDA tensors and copy them through host
memory themselves (``all_gather`` and ``all_reduce``, float32 and int32,
checked on an H100 with torch 2.11 by ``scripts/gloo_cuda_check.py``).
DTensor's own collectives do not: ``DTensor.full_tensor()`` goes through
the functional collectives, and on a gloo group with CUDA tensors its
``wait_tensor`` crashed the process (segmentation fault, torch 2.11 + CUDA
12.8 on an H100).  So :func:`full_tensor` gathers a row-sharded DTensor by
:func:`all_gather_rows` on every backend: one path, the same bytes as
``DTensor.full_tensor()``.
"""
from __future__ import annotations

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

__all__ = [
    "axes_group",
    "all_gather_rows",
    "all_reduce_sum",
    "full_tensor",
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
        return mesh.get_group(axes[0]), mesh.get_local_rank(axes[0])
    key = (dist.group.WORLD, mesh, axes)
    if key not in _groups:
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
        if found is None:
            raise ValueError(f"rank {me} is not in the mesh {mesh}")
        _groups[key] = found
    return _groups[key]


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (all of one shape), concatenated along dim 0 in
    the group's rank order; the same tensor on every rank."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, as a new tensor (the
    same bits on every rank)."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def full_tensor(dt) -> torch.Tensor:
    """The whole value of a DTensor sharded by rows (``Shard(0)``, equal
    shards) over a 1-D mesh, on every rank, gathered by
    :func:`all_gather_rows` (see the module docstring)."""
    from torch.distributed.tensor import Shard

    mesh = dt.device_mesh
    if mesh.ndim != 1 or tuple(dt.placements) != (Shard(0),) or dt.shape[0] % mesh.size():
        raise ValueError(f"full_tensor takes a Shard(0) DTensor of equal shards on a 1-D mesh, got "
                         f"{dt.placements} of {tuple(dt.shape)} on {mesh}")
    return all_gather_rows(dt.to_local(), mesh.get_group())


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
