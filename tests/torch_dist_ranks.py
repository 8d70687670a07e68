"""Rank functions of ``tests/test_torch_distributed.py``.

``repro_torch.parallel.run_ranks`` starts each rank with the spawn method,
which imports the function's module afresh in every process, so the
functions live here, in a module that imports neither JAX nor the test
file.  Each returns plain tensors and numbers (on the CPU) for the test to
hold against the JAX package's results.
"""
import warnings

import numpy as np
import torch
import torch.distributed as dist

SH = dict(block_size=8, update_interval=2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _tree(inp, key):
    return {"a": _t(inp[key + "_a"]), "b": _t(inp[key + "_b"])}


def main_ranks(inp):
    """Everything the test holds on four ranks: meshes, the two primitives,
    the band reduction, ``solve_many(devices=)`` in its three forms, the
    deprecated shims and ``compressed_psum``."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.backend.compat import make_mesh
    from repro_torch.core.distributed import (
        dist_band_reduce,
        dist_symm_matmul,
        dist_trailing_update,
        sharded_eigh_batch,
        sharded_inverse_roots,
    )
    from repro_torch.launch import make_local_mesh, make_production_mesh
    from repro_torch.optim import compressed_psum
    from repro_torch.parallel import axes_group, full_tensor
    from repro_torch.solver import EvdConfig, solve_many

    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    # ---- meshes
    local, local2 = make_local_mesh(device_type="cpu"), make_local_mesh(2, device_type="cpu")
    mesh = make_mesh((world,), ("x",), device_type="cpu")
    out["meshes"] = [(tuple(m.shape), tuple(m.mesh_dim_names), m.device_type) for m in (local, local2, mesh)]
    out["axes_index"] = [axes_group(local2, ax)[1] for ax in (("data", "model"), ("model", "data"), "data", "model")]
    errors = []
    for fn in (lambda: make_mesh((world + 1,), ("x",), device_type="cpu"),
               lambda: make_production_mesh(),
               lambda: make_local_mesh(3, device_type="cpu")):
        try:
            fn()
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["mesh_errors"] = errors

    # ---- the primitives and the band reduction
    A, Y, Z, V = (_t(inp[k]) for k in ("A", "Y", "Z", "V"))
    dt = dist_trailing_update(mesh, "x", A, Y, Z)
    rows = A.shape[0] // world
    a_sharded = DTensor.from_local(A[rank * rows:(rank + 1) * rows], mesh, [Shard(0)], run_check=False)
    out["trail_placements"] = tuple(dt.placements)
    out["trail_local"] = dt.to_local().clone()
    out["trail"] = dt.full_tensor()
    out["trail_gathered"] = full_tensor(dt)
    out["trail_from_dtensor"] = dist_trailing_update(mesh, "x", a_sharded, Y, Z).full_tensor()
    out["symm"] = dist_symm_matmul(mesh, "x", A, V)
    out["band"] = dist_band_reduce(mesh, "x", A, 4, 16)

    # ---- solve_many(devices=), every op in each form
    cfg = EvdConfig(b=4, nb=8)
    sym, psd = _tree(inp, "sym"), _tree(inp, "psd")
    forms = {"mesh": local2, "pair": (mesh, ("x",)), "sequence": ["cpu"] * world}
    for form, devices in forms.items():
        out[f"eigh_{form}"] = solve_many(sym, cfg, devices=devices)
        out[f"eigvals_{form}"] = solve_many(sym, cfg, op="eigvals", devices=devices)
        out[f"roots_{form}"] = solve_many(psd, cfg, op="inverse_pth_root", devices=devices)

    # ---- the deprecated shims
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["shim_eigh"] = sharded_eigh_batch(local2, ("data", "model"), sym["a"], config=cfg)
        out["shim_roots"] = sharded_inverse_roots(mesh, ("x",), psd["a"], 4, b=4, nb=8)
    out["shim_warnings"] = [(w.category.__name__, str(w.message)) for w in caught]
    out["shim_eigh_direct"] = solve_many(sym["a"], cfg, devices=(local2, ("data", "model")))
    out["shim_roots_direct"] = solve_many(psd["a"], cfg, op="inverse_pth_root", devices=(mesh, ("x",)))
    try:
        sharded_eigh_batch(mesh, ("x",), sym["a"], config=cfg, b=4)
        out["shim_both"] = None
    except ValueError as e:
        out["shim_both"] = str(e)

    # ---- compressed_psum: the replicated input, then one input a rank
    x = _t(inp["x"])
    out["psum"] = compressed_psum(mesh, "x", x)
    x_own = x * (1.0 + 0.25 * rank)
    out["psum_own"] = compressed_psum(mesh, "x", x_own)
    out["psum_own_in"] = x_own
    return out


def band_ranks(inp):
    """``dist_band_reduce`` on however many ranks the world holds (three
    takes the local branch on some blocks)."""
    from repro_torch.backend.compat import make_mesh
    from repro_torch.core.distributed import dist_band_reduce

    mesh = make_mesh((dist.get_world_size(),), ("x",), device_type="cpu")
    return dist_band_reduce(mesh, "x", _t(inp["A"]), 4, 16)


def shampoo_ranks(state, params, grads):
    """Three Shampoo updates with ``precond_mesh`` from one JAX-made state;
    per step the preconditioners, the updates and the parameters."""
    from repro_torch import interop, optim
    from repro_torch.backend.compat import make_mesh
    from repro_torch.solver import EvdConfig

    mesh = make_mesh((dist.get_world_size(),), ("x",), device_type="cpu")
    opts = optim.ShampooOptions(**SH, evd=EvdConfig(b=4, nb=8), precond_mesh=(mesh, ("x",)))
    opt = optim.shampoo(1e-2, opts=opts, grad_clip=None)
    pstate = interop.shampoo_state(state)
    pp = interop.model_params(params)
    steps = []
    for g in grads:
        pu, pstate = opt.update(interop.model_params(g), pstate, pp)
        pp = optim.apply_updates(pp, pu)
        steps.append(dict(pre_l=pstate.pre_l, pre_r=pstate.pre_r, updates=pu, params=pp))
    return steps


def failing_rank(bad_rank):
    """Raises on ``bad_rank`` only; the others wait in a collective."""
    if dist.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    dist.barrier()
    return dist.get_rank()


def dying_rank(bad_rank):
    """Ends ``bad_rank``'s process without a word, as a crash would."""
    import os

    if dist.get_rank() == bad_rank:
        os._exit(3)
    dist.barrier()
    return dist.get_rank()
