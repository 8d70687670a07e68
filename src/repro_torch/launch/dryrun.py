"""The dry-run: one step of every (arch x shape) cell on the production
meshes, traced on fake tensors by rank 0 of a fake world, with its memory,
FLOPs, HBM bytes, collective bytes and roofline (port of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \\
        --shape train_4k [--multi-pod] [--out experiments/dryrun_torch]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-370m \\
        --shape decode_32k --mesh 2,4 --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k --optimizer shampoo [--shampoo-sharded]

The JAX package lowers and compiles each cell for 512 fake CPU devices and
reads XLA's analyses.  The port runs the cell's step instead, as rank 0 of
a world of the mesh's size on c10d's ``fake`` backend
(``parallel.comm.fake_world``: groups and meshes build, collectives move
nothing), on fake tensors (``FakeTensorMode``: shapes, dtypes and devices,
no data and no compute) of rank 0's shards, under the policy the JAX
function picks.  What runs is the step a real rank runs, branch for branch:

* ``memory``: the bytes of rank 0's inputs (``argument_bytes``; by input
  in ``argument_bytes_by_input``), the step's
  new outputs and those that alias an input (the decode cache, written in
  place), the most bytes its ops hold at once beyond the inputs
  (``analysis.walk``), and ``peak_estimate_bytes`` = inputs + that most;
* ``walk``: FLOPs (every recomputation included) and HBM bytes op by op,
  with the top contributors (``analysis.walk``); ``cost`` repeats them
  under the JAX record's names (there is no separate cost analysis);
* ``collectives``: the bytes ``parallel.comm`` counted by kind and by
  group (``analysis.collectives``);
* ``roofline``: the three terms against the H100's peaks
  (``analysis.roofline``), and ``trace_s``, the step's time on fake
  tensors (JAX's ``lower_s`` and ``compile_s``).

The step runs on fake tensors of ``device`` (default ``"cuda"``, which
raises without a card: pass ``device="cpu"``).

``optimizer_name="shampoo"`` trains a cell with the JAX function's
options (``shampoo(3e-4, ShampooOptions(block_size=256, update_interval=20,
evd=EvdConfig(b=8, nb=64)))``).  Its step refreshes the preconditioners:
on a card through kernels A–C, whose ``repro_torch`` operators have fake
implementations and work formulas (``kernels/library.py``), on the CPU
through their plain versions op by op.  The state is what the port holds,
whole leaves on every rank (``Optimizer.whole_leaves``), not JAX's layout,
where ``mu`` and ``nu`` mirror the parameters' shardings;
``shampoo_sharded`` splits the refresh over every mesh axis
(``precond_mesh``, JAX's ``P(axes, None, None)`` on the statistics), so
rank 0 refreshes its share and gathers the roots.  The record gains
``shampoo`` (blocks, rank 0's share, the state's bytes by part, the
refresh's FLOPs by operator, whether it was counted), and the walk lists
the loops whose trips depend on values (``walk["data_dependent"]``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Dict, Optional, Tuple

__all__ = ["run_cell", "count_cell", "cell_config", "cell_inputs", "cell_step", "cell_optimizer",
           "shampoo_options", "summary", "main"]

SKIP_REASON = ("long_500k requires sub-quadratic serving state "
               "(pure full-attention arch; see DESIGN.md §6)")
OPTIMIZERS = ("adamw", "shampoo")
REFRESH_NOTE = ("a fake step has no value, so it refreshes: the JAX walk counts both branches of its lax.cond, "
                "an upper bound, and the keep branch is free")


def _mesh_shape(multi_pod: bool, mesh_override) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD

    if mesh_override is not None:
        shape = tuple(int(s) for s in mesh_override)
        return shape, ("pod", "data", "model")[-len(shape):]
    return (MULTI_POD, ("pod", "data", "model")) if multi_pod else (SINGLE_POD, ("data", "model"))


def cell_config(arch: str, shape: str, *, multi_pod: bool = False, overrides=None, mesh_override=None,
                pure_dp=None, microbatches=None, shape_overrides=None, smoke: bool = False):
    """``(cfg, info, mesh shape, axis names, pure_dp, microbatches)`` of a
    cell: the config with ``overrides`` and the shard modes the mesh gives,
    the shape's ``SHAPES`` entry (with ``shape_overrides``), and the JAX
    function's auto policies where ``pure_dp`` / ``microbatches`` are None."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.specs import SHAPES
    from repro_torch.parallel.sharding import resolve_attn_mode, resolve_moe_mode

    cfg = (get_smoke_config if smoke else get_config)(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    info = dict(SHAPES[shape], **(shape_overrides or {}))
    mesh_shape, axes = _mesh_shape(multi_pod, mesh_override)
    sizes = dict(zip(axes, mesh_shape))
    model_axis = sizes["model"]
    n_chips = math.prod(mesh_shape)
    if pure_dp is None:
        # Auto policy (the JAX package's): models <= 4B parameters train as
        # pure data parallelism over the whole mesh, where the batch divides.
        pure_dp = (info["kind"] == "train" and cfg.param_counts()["total"] <= 4e9
                   and info["batch"] % n_chips == 0)
    if microbatches is None:
        # Auto policy: gradient accumulation for big tensor-parallel train cells.
        microbatches = 8 if (info["kind"] == "train" and not pure_dp
                             and cfg.param_counts()["total"] > 4e9) else 1
    over = {"attn_shard_mode": "none" if pure_dp else resolve_attn_mode(cfg, model_axis),
            "moe_shard_mode": "tp" if pure_dp else resolve_moe_mode(cfg, model_axis)}
    if over["attn_shard_mode"] == "cp" and info["kind"] != "decode":
        over["attn_chunk"] = max(info["seq"] // model_axis, 128)
    return dataclasses.replace(cfg, **over), info, mesh_shape, axes, pure_dp, microbatches


def _batch_axes(mesh, pure_dp: bool) -> Tuple[str, ...]:
    names = tuple(mesh.mesh_dim_names)
    if pure_dp:
        return names
    return tuple(a for a in ("pod", "data") if a in names)


def _rows(mesh, axes, n: int) -> Tuple[int, int]:
    """This rank's rows ``[lo, hi)`` of a batch of ``n`` over ``axes``, or
    all of them where ``axes`` do not divide it (as JAX replicates it)."""
    from repro_torch.parallel import comm

    k = math.prod(mesh.size(tuple(mesh.mesh_dim_names).index(a)) for a in axes)
    if not axes or n % k:
        return 0, n
    i = comm.axes_group(mesh, axes)[1]
    return i * n // k, (i + 1) * n // k


def cell_inputs(cfg, info, policy, dev, *, pure_dp: bool, optimizer=None) -> Dict:
    """Rank ``dist.get_rank()``'s inputs of the cell's step as new tensors
    on ``dev`` (fake ones inside a ``FakeTensorMode``): its shards of the
    parameters (and of the optimizer state, from ``init_opt_state``; an
    optimizer of whole leaves, Shampoo, holds its whole state) or of
    the cache (``cache_partition_specs``), its rows of the batch, in the
    trees of ``launch.specs.input_specs``; zeros (what a step counts does
    not depend on the values)."""
    import torch

    from repro_torch.launch.cache_specs import cache_partition_specs
    from repro_torch.launch.specs import batch_specs
    from repro_torch.models import cache_meta, model_meta
    from repro_torch.tree import flatten_with_paths, tree_map

    mesh = policy.mesh

    def local(tree, shardings):
        paths, ts, rebuild = flatten_with_paths(tree)
        shs = flatten_with_paths(shardings)[1]
        return rebuild([torch.zeros(sh.local_shape(t.shape, path), dtype=t.dtype, device=dev)
                        for path, t, sh in zip(paths, ts, shs)])

    meta = model_meta(cfg)
    params = local(meta, policy.param_shardings(meta))
    if info["kind"] == "decode":  # the cache's rows, on the data axes (launch.cache_specs)
        cm = cache_meta(cfg, info["batch"], info["seq"])
        cache = local(cm, cache_partition_specs(cfg, mesh, policy, cm))
        lo, hi = _rows(mesh, _batch_axes(mesh, False), info["batch"])
        return {"params": params, "cache": cache, "tokens": torch.zeros((hi - lo, 1), dtype=torch.int32, device=dev)}
    lo, hi = _rows(mesh, _batch_axes(mesh, pure_dp), info["batch"])
    batch = {k: torch.zeros(m.shape, dtype=m.dtype, device=dev)
             for k, m in batch_specs(cfg, info["seq"], hi - lo, train=info["kind"] == "train").items()}
    if info["kind"] == "prefill":
        return {"params": params, "batch": batch}
    from repro_torch.train.step import init_opt_state

    if optimizer.whole_leaves:  # the state of the whole leaves, on every rank (init_opt_state gathers them)
        state = optimizer.init(tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype, device=dev), meta))
    else:
        state = init_opt_state(optimizer, params)
    return {"params": params, "opt_state": state, "batch": batch, "step": 0}


def cell_step(cfg, info, policy, dev, *, microbatches: int = 1, optimizer=None):
    """``(fn, arg names)``: the step a rank runs for the cell under
    ``policy`` (the sharded train step, prefill or serve step)."""
    from repro_torch.train import make_prefill, make_serve_step, make_train_step

    if info["kind"] == "train":
        return make_train_step(cfg, optimizer, microbatches=microbatches, policy=policy), \
            ("params", "opt_state", "batch", "step")
    if info["kind"] == "prefill":
        return make_prefill(cfg, policy=policy, device=dev), ("params", "batch")
    return make_serve_step(cfg, policy=policy, device=dev), ("params", "cache", "tokens")


def _bytes(tree) -> int:
    import torch

    from repro_torch.tree import leaves

    return sum(t.numel() * t.element_size() for t in leaves(tree) if isinstance(t, torch.Tensor))


def _policy(arch, shape, dev, *, multi_pod=False, overrides=None, mesh_override=None, sequence_parallel=False,
            fsdp=True, pure_dp=None, microbatches=None, shape_overrides=None, smoke=False):
    """``(cfg, info, policy, pure_dp, microbatches)`` of a cell, its mesh
    built in the initialized world (fake or real)."""
    from repro_torch.backend.compat import make_mesh
    from repro_torch.parallel.sharding import make_policy

    cfg, info, mesh_shape, axes, pure_dp, microbatches = cell_config(
        arch, shape, multi_pod=multi_pod, overrides=overrides, mesh_override=mesh_override, pure_dp=pure_dp,
        microbatches=microbatches, shape_overrides=shape_overrides, smoke=smoke)
    mesh = make_mesh(mesh_shape, axes, device_type=dev.type)
    policy = make_policy(mesh, cfg, fsdp=fsdp, sequence_parallel=sequence_parallel, pure_dp=pure_dp)
    return cfg, info, policy, pure_dp, microbatches


def shampoo_options(mesh=None, sharded: bool = False):
    """The JAX dry-run's Shampoo options, with the refresh split over every
    axis of ``mesh`` when ``sharded``."""
    from repro_torch.optim import ShampooOptions
    from repro_torch.solver import EvdConfig

    precond = (mesh, tuple(mesh.mesh_dim_names)) if sharded else None
    return ShampooOptions(block_size=256, update_interval=20, evd=EvdConfig(b=8, nb=64), precond_mesh=precond)


def cell_optimizer(info, policy, optimizer_name: str = "adamw", shampoo_sharded: bool = False):
    """The cell's optimizer as the JAX ``run_cell`` builds it (None unless
    it trains): ``adamw(3e-4)`` or ``shampoo(3e-4, shampoo_options(...))``."""
    from repro_torch.optim import adamw, shampoo

    if optimizer_name not in OPTIMIZERS:
        raise ValueError(f"optimizer_name={optimizer_name!r}: expected one of {OPTIMIZERS}")
    if info["kind"] != "train":
        return None
    if optimizer_name == "shampoo":
        return shampoo(3e-4, shampoo_options(policy.mesh, shampoo_sharded))
    return adamw(3e-4)


def _step(cfg, info, policy, dev, pure_dp, microbatches, optimizer):
    """``(inputs, fn, args)``: the rank's inputs and step (fake tensors
    inside a ``FakeTensorMode``)."""
    inputs = cell_inputs(cfg, info, policy, dev, pure_dp=pure_dp, optimizer=optimizer)
    fn, names = cell_step(cfg, info, policy, dev, microbatches=microbatches, optimizer=optimizer)
    return inputs, fn, [inputs[k] for k in names]


def _shampoo_record(opt_state, opts, walk) -> Dict:
    """The ``shampoo`` entry of a record: blocks a side, rank 0's share of
    the refresh (identity lanes padding the batch to a multiple of the
    ranks included), the state's bytes by part, the refresh's FLOPs by
    operator and whether the refresh was counted."""
    blocks = opt_state.stats_l.shape[0]
    ranks = opts.precond_mesh[0].size() if opts.precond_mesh is not None else 1
    lanes = -(-blocks // ranks)
    return {
        "block_size": opts.block_size,
        "blocks_per_side": blocks,
        "sharded": opts.precond_mesh is not None,
        "refresh_ranks": ranks,
        "rank0_lanes_per_side": lanes,
        "rank0_blocks_per_side": min(lanes, blocks),
        "state_bytes": {k: _bytes(getattr(opt_state, k)) for k in opt_state._fields},
        "refresh_flops_by_operator": {k: v["flops"] for k, v in walk["operators"].items()},
        "refresh_calls_by_operator": {k: v["count"] for k, v in walk["operators"].items()},
        "refresh_counted": True,
        "refresh_note": REFRESH_NOTE,
    }


def run_cell(arch: str, shape: str, *, multi_pod: bool = False, overrides=None, mesh_override=None,
             sequence_parallel: bool = False, fsdp: bool = True, optimizer_name: str = "adamw",
             shampoo_sharded: bool = False, pure_dp=None, microbatches=None, device=None,
             shape_overrides=None, smoke: bool = False, top: int = 12, quiet: bool = False) -> Dict:
    """One cell's record (module docstring), the JAX ``run_cell``'s keys
    with ``trace_s`` for ``lower_s`` / ``compile_s``.  ``shape_overrides``
    changes the shape's batch or seq; ``smoke`` starts from the reduced
    config; ``top`` contributors are kept; ``optimizer_name`` is
    ``"adamw"`` or ``"shampoo"`` (with ``shampoo_sharded``: the refresh
    over every mesh axis)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import analyze_step, collective_bytes, roofline_terms
    from repro_torch.backend.probe import resolve_device
    from repro_torch.configs import canonical
    from repro_torch.launch.specs import cell_applicable
    from repro_torch.parallel import comm
    from repro_torch.tree import leaves

    arch = canonical(arch)
    if not cell_applicable(arch, shape):
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod, "status": "skipped", "reason": SKIP_REASON}
    dev = resolve_device(device)
    mesh_shape, axes = _mesh_shape(multi_pod, mesh_override)
    with comm.fake_world(math.prod(mesh_shape)):
        cfg, info, policy, pure_dp, microbatches = _policy(
            arch, shape, dev, multi_pod=multi_pod, overrides=overrides, mesh_override=mesh_override,
            sequence_parallel=sequence_parallel, fsdp=fsdp, pure_dp=pure_dp, microbatches=microbatches,
            shape_overrides=shape_overrides, smoke=smoke)
        optimizer = cell_optimizer(info, policy, optimizer_name, shampoo_sharded)
        fake = FakeTensorMode()
        with fake:
            inputs, fn, args = _step(cfg, info, policy, dev, pure_dp, microbatches, optimizer)
        in_keys = {t.untyped_storage()._cdata for t in leaves(inputs) if isinstance(t, torch.Tensor)}
        comm.reset_traffic()
        t0 = time.perf_counter()
        with fake:
            out, walk = analyze_step(fn, *args, top=top)
        trace_s = time.perf_counter() - t0
        colls = collective_bytes()
        comm.reset_traffic()
        outs = [t for t in leaves(out) if isinstance(t, torch.Tensor)]
        alias = sum(t.numel() * t.element_size() for t in outs if t.untyped_storage()._cdata in in_keys)
        out_bytes = sum(t.numel() * t.element_size() for t in outs) - alias
        arg_bytes = _bytes(inputs)
    record = {
        "arch": arch,
        "shape": shape,
        "multi_pod": "pod" in axes,
        "status": "ok",
        "mesh": dict(zip(axes, mesh_shape)),
        "policy": {"pure_dp": pure_dp, "fsdp": fsdp, "sequence_parallel": sequence_parallel,
                   "microbatches": microbatches,
                   "attn_shard_mode": cfg.attn_shard_mode, "moe_shard_mode": cfg.moe_shard_mode},
        "device": str(dev),
        "trace_s": round(trace_s, 1),
        "argument_bytes_by_input": {k: _bytes(v) for k, v in inputs.items()},
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": max(walk["peak_live_bytes"] - out_bytes, 0),
            "alias_bytes": alias,
            "peak_estimate_bytes": arg_bytes + walk["peak_live_bytes"],
        },
        "cost": {"flops_per_device": float(walk["flops"]), "bytes_accessed_per_device": float(walk["hbm_bytes"])},
        "collectives": colls,
        "walk": {
            "top_bytes": walk.get("top_bytes", []),
            "top_flops": walk.get("top_flops", []),
            "flops_per_device": float(walk["flops"]),
            "hbm_bytes_per_device": float(walk["hbm_bytes"]),
            "collective_bytes_per_device": float(colls["total_bytes"]),
            "collectives": colls["per_kind"],
            "peak_live_bytes": walk["peak_live_bytes"],
            "ops": walk["ops"],
            "flops_note": walk["flops_note"],
            "operators": walk["operators"],
            "data_dependent": walk["data_dependent"],
            "flops_outside_loops": float(walk["flops_outside_loops"]),
            "hbm_bytes_outside_loops": float(walk["hbm_bytes_outside_loops"]),
        },
    }
    if optimizer_name == "shampoo" and info["kind"] == "train":
        record["shampoo"] = _shampoo_record(inputs["opt_state"], shampoo_options(policy.mesh, shampoo_sharded), walk)
    record["roofline"] = roofline_terms(record, cfg, info)
    if not quiet:
        print(summary(record))
    return record


def count_cell(arch: str, shape: str, *, mesh_override, device=None, optimizer_name: str = "adamw",
               shampoo_sharded: bool = False, timed: bool = True, **kw) -> Dict:
    """The cell's step run for real by this rank of the initialized world
    (every rank calls it with the same arguments; the mesh's size is the
    world's), twice: the first run under ``FlopCounterMode`` and the walk
    (``analysis.walk.StepWalk``, on real tensors) gives ``collectives``
    (``analysis.collective_bytes``), ``flops`` and ``operators`` (the
    FLOPs of each ``repro_torch`` operator) as ``FlopCounterMode`` counts
    them, and from the walk ``walk_flops``, ``hbm_bytes``,
    ``data_dependent`` (the loops whose trips depend on values, with the
    FLOPs and bytes counted inside them), ``flops_outside_loops`` and
    ``hbm_bytes_outside_loops``; the second ``step_s`` (without ``timed``,
    no second run).  On CUDA ``peak_bytes`` is the inputs' bytes plus the
    most ``torch.cuda.max_memory_allocated`` rose over what was held before
    the last run.  A dry-run record of the same cell holds its rank 0's
    counts against these.  ``optimizer_name`` / ``shampoo_sharded`` and
    ``kw`` as :func:`run_cell`'s."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis import collective_bytes
    from repro_torch.analysis.walk import StepWalk
    from repro_torch.backend.probe import resolve_device
    from repro_torch.backend.trace import NAMESPACE
    from repro_torch.kernels import library  # noqa: F401  (the operators' formulas, before FlopCounterMode copies them)
    from repro_torch.parallel import comm

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    cfg, info, policy, pure_dp, microbatches = _policy(arch, shape, dev, mesh_override=mesh_override, **kw)
    optimizer = cell_optimizer(info, policy, optimizer_name, shampoo_sharded)
    inputs, fn, args = _step(cfg, info, policy, dev, pure_dp, microbatches, optimizer)

    def held():
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            return torch.cuda.memory_allocated()

    def peak(before):
        if cuda:
            torch.cuda.synchronize()
            rec["peak_bytes"] = _bytes(inputs) + torch.cuda.max_memory_allocated() - before

    comm.reset_traffic()
    before = held()
    with FlopCounterMode(display=False) as fc, StepWalk() as walk:
        out = fn(*args)
    colls = collective_bytes()
    comm.reset_traffic()
    del out
    w = walk.record()
    ops = {str(k).split(".")[-1]: v for k, v in fc.get_flop_counts()["Global"].items()
           if str(k).startswith(NAMESPACE + ".")}
    rec = {"collectives": colls, "flops": float(fc.get_total_flops()), "operators": ops,
           "walk_flops": float(w["flops"]), "hbm_bytes": float(w["hbm_bytes"]),
           "data_dependent": w["data_dependent"], "flops_outside_loops": float(w["flops_outside_loops"]),
           "hbm_bytes_outside_loops": float(w["hbm_bytes_outside_loops"])}
    if not timed:
        peak(before)
        return rec
    before = held()
    t0 = time.perf_counter()
    out = fn(*args)
    peak(before)
    rec["step_s"] = time.perf_counter() - t0
    comm.reset_traffic()
    return rec


def summary(record: Dict) -> str:
    """The one-line summary of a record, as the JAX ``run_cell`` prints."""
    if record["status"] != "ok":
        why = record.get("reason") or record.get("error")
        return f"[dryrun] {record['arch']} x {record['shape']}: {record['status']} ({why})"
    rf = record["roofline"]
    return (f"[dryrun] {record['arch']} x {record['shape']} ({'2-pod' if record['multi_pod'] else '1-pod'}, mesh "
            f"{record['mesh']}): trace {record['trace_s']:.1f}s, "
            f"{record['memory']['peak_estimate_bytes'] / 2**30:.2f} GiB/device, "
            f"{record['walk']['flops_per_device'] / 1e9:.1f} GFLOP/device (walked), "
            f"coll {record['collectives']['total_bytes'] / 2**20:.1f} MiB/device, dominant {rf['dominant']}, "
            f"roofline_frac {rf['roofline_fraction']:.3f}")


def main(argv=None):
    from repro_torch.launch.specs import SHAPES, all_cells

    p = argparse.ArgumentParser()
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None, choices=list(SHAPES))
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--all", action="store_true")
    p.add_argument("--out", default="experiments/dryrun_torch")
    p.add_argument("--smoke", action="store_true", help="use reduced configs")
    p.add_argument("--mesh", default=None, help="debug mesh override, e.g. '2,4' or '2,2,4'")
    p.add_argument("--device", default=None, help="the fake tensors' device (default cuda; cpu without a card)")
    p.add_argument("--optimizer", default="adamw", choices=OPTIMIZERS, help="the train cells' optimizer")
    p.add_argument("--shampoo-sharded", action="store_true", help="split the Shampoo refresh over every mesh axis")
    args = p.parse_args(argv)
    mesh_override = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None

    os.makedirs(args.out, exist_ok=True)
    cells = [(a, s) for a, s, _ in all_cells()] if args.all else [(args.arch, args.shape)]
    failures = 0
    for arch, shape in cells:
        opt = "" if args.optimizer == "adamw" else f"_{args.optimizer}{'_sharded' if args.shampoo_sharded else ''}"
        tag = f"{arch}_{shape}_{'2pod' if args.multi_pod else '1pod'}{opt}"
        try:
            rec = run_cell(arch, shape, multi_pod=args.multi_pod, mesh_override=mesh_override,
                           device=args.device, smoke=args.smoke, optimizer_name=args.optimizer,
                           shampoo_sharded=args.shampoo_sharded)
            if rec["status"] != "ok":
                print(summary(rec))
        except Exception as e:  # noqa: BLE001 — record, keep sweeping
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "multi_pod": args.multi_pod, "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
            failures += 1
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=2)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
