"""Rank functions of ``tests/test_torch_sharding.py`` and of the sharded
launcher and restore tests in ``tests/test_torch_train.py``.

``repro_torch.parallel.run_ranks`` starts each rank with the spawn method,
which imports the function's module afresh in every process, so the
functions live here, in a module that imports neither JAX nor the test
files.  Each returns plain tensors, numbers and strings for the tests to
hold against the JAX package's results and the port's one-process step.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

MESH = (2, 2)  # (data, model)


def case_config(case):
    """The port's config of a case: the smoke config with the case's
    overrides (the shard modes included)."""
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(case["arch"]), **case["over"])


def case_policy(case, cfg, mesh):
    from repro_torch.parallel import ShardingPolicy, make_policy

    policy = make_policy(mesh, cfg, **case.get("policy", {}))
    rules = case.get("rules")
    if rules:
        pr, ar = dict(policy.param_rules), dict(policy.activation_rules)
        pr.update(rules.get("param", {}))
        ar.update(rules.get("act", {}))
        policy = ShardingPolicy(mesh, pr, ar)
    return policy


def case_optimizer(case, precond_mesh=None):
    from repro_torch import optim
    from repro_torch.solver import EvdConfig

    if case.get("opt") == "shampoo":
        return optim.shampoo(1e-2, opts=optim.ShampooOptions(block_size=16, update_interval=10,
                                                             evd=EvdConfig(b=4, nb=8), precond_mesh=precond_mesh))
    return optim.adamw(1e-2)


def start_state(opt, state):
    """The tests' starting state (as tests/test_torch_train.py's): the
    second moment 1, so an update is linear in the gradient; Shampoo's
    statistics 1.5 I."""
    from repro_torch.tree import tree_map

    state = state._replace(nu=tree_map(torch.ones_like, state.nu))
    if hasattr(state, "stats_l"):
        eye = 1.5 * torch.eye(state.stats_l.shape[-1]).expand(state.stats_l.shape).clone()
        state = state._replace(stats_l=eye, stats_r=eye.clone())
    return state


def batch_of(inp, name):
    pre = name + "/batch/"
    return {k[len(pre):]: torch.as_tensor(v) for k, v in inp.items() if k.startswith(pre)}


def params_of(inp, name):
    from repro_torch import interop

    pre = name + "/params/"
    flat = {k[len(pre):]: v for k, v in inp.items() if k.startswith(pre)}
    tree = _unflatten(flat)
    tree.setdefault("rem", {})  # an empty subtree has no arrays to carry
    return interop.model_params(tree)


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def _np(t):
    return t.detach().cpu().numpy()


def sharding_ranks(inp, cases, ckpt_dir):
    """Every case's sharded step on the (2, 2) mesh; local shapes; the
    errors; the sharded checkpoint round trip."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch import make_local_mesh
    from repro_torch.models import model_meta
    from repro_torch.parallel import gather_params, shard_params
    from repro_torch.train import make_train_step
    from repro_torch.train.step import init_opt_state
    from repro_torch.tree import flatten_with_paths, leaves, tree_map

    mesh = make_local_mesh(MESH[1], device_type="cpu")
    out = {}
    for name, case in cases.items():
        cfg = case_config(case)
        policy = case_policy(case, cfg, mesh)
        shardings = policy.param_shardings(model_meta(cfg))
        params = shard_params(params_of(inp, name), shardings)
        opt = case_optimizer(case, (mesh, ("data", "model")))
        state = start_state(opt, init_opt_state(opt, params))
        res = policy.resolver()
        n, i = res.size("act_batch"), res.index("act_batch")
        batch = batch_of(inp, name)
        rows = {k: v[i * v.shape[0] // n:(i + 1) * v.shape[0] // n] for k, v in batch.items()}
        step = make_train_step(cfg, opt, microbatches=case.get("micro", 1), policy=policy)
        new, new_state, metrics = step(params, state, rows, 0)
        paths = flatten_with_paths(params)[0]
        out[name] = dict(
            metrics={k: float(v) for k, v in metrics.items()},
            loss_bits=metrics["loss"].numpy().tobytes(),
            params={p: _np(t) for p, t in zip(paths, leaves(gather_params(new)))},
            mu={p: _np(t) for p, t in zip(paths, leaves(gather_params(new_state.mu)))},
            local_shapes={p: tuple(t.to_local().shape) for p, t in zip(paths, leaves(params))},
        )

    # comm.reduce_scatter over "model" of 5 columns (3 and 2 a rank), and
    # its backward: the all-gather of each rank's (index + 1) cotangent.
    from repro_torch.parallel import comm

    x = torch.arange(15, dtype=torch.float32).reshape(3, 5) * (dist.get_rank() + 1)
    x.requires_grad_(True)
    y = comm.reduce_scatter(x, mesh, "model", 1)
    j = comm.axes_group(mesh, ("model",))[1]
    (y * (j + 1)).sum().backward()
    out["reduce_scatter"] = dict(y=_np(y), grad=_np(x.grad))

    # Errors: a dim the axes do not divide; a recurrent mixer under TP.
    errors = {}
    cfg = dataclasses.replace(case_config(cases["heads"]), vocab=511)
    from repro_torch.models import model_params
    from repro_torch.parallel import make_policy

    try:
        shard_params(model_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
                     make_policy(mesh, cfg).param_shardings(model_meta(cfg)))
    except ValueError as e:
        errors["indivisible"] = str(e)
    for arch in ("mamba2-370m", "recurrentgemma-2b"):
        from repro_torch.configs import get_smoke_config
        from repro_torch import optim

        cfg = dataclasses.replace(get_smoke_config(arch), vocab=256)
        policy = make_policy(mesh, cfg)
        params = shard_params(model_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
                              policy.param_shardings(model_meta(cfg)))
        opt = optim.adamw(1e-2)
        tokens = torch.zeros((2, 32), dtype=torch.int32)
        try:
            make_train_step(cfg, opt, policy=policy)(params, init_opt_state(opt, params),
                                                     {"tokens": tokens, "labels": tokens}, 0)
        except NotImplementedError as e:
            errors[arch] = str(e)
    from repro_torch.parallel import make_mesh_resolver

    res = make_mesh_resolver(mesh, {"act_mlp": "model"})
    try:  # a partial sum whose hint misnames the rank would stay unreduced
        res(torch.ones(2, 3), ("act_batch", None, "act_mlp"), partial="act_mlp")
    except ValueError as e:
        errors["hint_rank"] = str(e)
    out["errors"] = errors

    # A (2, 2) save restores on (1, 4) (and, in the test, in one process).
    case = cases["heads"]
    cfg = case_config(case)
    meta = model_meta(cfg)
    sh22 = case_policy(case, cfg, mesh).param_shardings(meta)
    whole = params_of(inp, "heads")
    mgr = CheckpointManager(ckpt_dir, async_save=False)
    mgr.save(1, {"params": shard_params(whole, sh22)})
    dist.barrier()
    mesh14 = make_local_mesh(4, device_type="cpu")
    sh14 = case_policy(case, cfg, mesh14).param_shardings(meta)
    back = mgr.restore(1, {"params": whole}, shardings=sh14)["params"]
    out["restore14"] = dict(
        local_shapes=[tuple(t.to_local().shape) for t in leaves(back)],
        equal=all(torch.equal(a, b) for a, b in zip(leaves(gather_params(back)), leaves(whole))))
    return out


def launcher_ranks(argv, ckpt_dir, whole):
    """``main(argv)`` on this world, then its checkpoint restored with
    ``shardings=`` onto the world's mesh, gathered back."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import make_local_mesh
    from repro_torch.launch.train import main
    from repro_torch.models import model_meta
    from repro_torch.parallel import gather_params, make_policy
    from repro_torch.tree import leaves

    history = main(argv)
    dist.barrier()
    cfg = get_smoke_config("llama3.2-3b")
    shardings = make_policy(make_local_mesh(2, device_type="cpu"), cfg).param_shardings(model_meta(cfg))
    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step()
    back = mgr.restore(step, {"params": whole}, shardings=shardings)["params"]
    return dict(history=history, step=step,
                local_shapes=[tuple(t.to_local().shape) for t in leaves(back)],
                whole=[_np(t) for t in leaves(gather_params(back))])
