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


def float64_config(cfg):
    return dataclasses.replace(cfg, dtype="float64", param_dtype="float64")


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

    mesh = case_mesh({})
    out = {}
    for name, case in cases.items():
        cfg = case_config(case)
        policy = case_policy(case, cfg, case_mesh(case))
        shardings = policy.param_shardings(model_meta(cfg))
        params = shard_params(params_of(inp, name), shardings)
        opt = case_optimizer(case, (policy.mesh, ("data", "model")))
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
        if case.get("f64"):  # the same step in float64
            c64 = float64_config(cfg)
            p64 = shard_params(tree_map(torch.Tensor.double, params_of(inp, name)),
                               policy.param_shardings(model_meta(c64)))
            s64 = start_state(opt, init_opt_state(opt, p64))
            n64, st64, _ = make_train_step(c64, opt, policy=policy)(p64, s64, rows, 0)
            out[name]["params64"] = {p: _np(t) for p, t in zip(paths, leaves(gather_params(n64)))}
            out[name]["mu64"] = {p: _np(t) for p, t in zip(paths, leaves(gather_params(st64.mu)))}

    # comm.reduce_scatter over "model" of 5 columns (3 and 2 a rank), and
    # its backward: the all-gather of each rank's (index + 1) cotangent.
    from repro_torch.parallel import comm

    x = torch.arange(15, dtype=torch.float32).reshape(3, 5) * (dist.get_rank() + 1)
    x.requires_grad_(True)
    y = comm.reduce_scatter(x, mesh, "model", 1)
    j = comm.axes_group(mesh, ("model",))[1]
    (y * (j + 1)).sum().backward()
    out["reduce_scatter"] = dict(y=_np(y), grad=_np(x.grad))

    # Errors: a dim the axes do not divide; none from a recurrent mixer
    # under TP (its step runs: "ran" and the loss).
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

        from repro_torch.parallel import resolve_attn_mode

        cfg = dataclasses.replace(get_smoke_config(arch), vocab=256)
        cfg = dataclasses.replace(cfg, attn_shard_mode=resolve_attn_mode(cfg, 2))
        policy = make_policy(mesh, cfg)
        params = shard_params(model_params(cfg, torch.Generator().manual_seed(0), device="cpu"),
                              policy.param_shardings(model_meta(cfg)))
        opt = optim.adamw(1e-2)
        tokens = torch.zeros((2, 32), dtype=torch.int32)
        try:
            m = make_train_step(cfg, opt, policy=policy)(params, init_opt_state(opt, params),
                                                         {"tokens": tokens, "labels": tokens}, 0)[2]
            errors[arch] = f"ran, loss {float(m['loss'])}"
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
    mesh14 = case_mesh({"mesh": (1, 4)})
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


_MESHES = {}


def case_mesh(case):
    """A case's ``(data, model)`` mesh over the world of four (one mesh a
    shape in each rank)."""
    from repro_torch.launch import make_local_mesh

    model = tuple(case.get("mesh", MESH))[1]
    if model not in _MESHES:
        _MESHES[model] = make_local_mesh(model, device_type="cpu")
    return _MESHES[model]


def _whole_cache(cfg, policy, mesh, local, shardings):
    """Every leaf of a rank's cache gathered whole over the axes that split
    it; the B/C window (replicated) as the rank's own rows."""
    from repro_torch.tree import flatten_with_paths

    paths, ts, rebuild = flatten_with_paths(local)
    shs = flatten_with_paths(shardings)[1]
    return {p: _np(sh.gather(t)) for p, t, sh in zip(paths, ts, shs)}


def serve_ranks(inp, cases, default_steps):
    """Every case's sharded prefill and teacher-forced decode: the prefill
    tokens, each decode step's greedy tokens, the final cache (gathered),
    and each step's logits (gathered over the vocabulary) from
    ``decode_step`` under the policy's resolver on a second cache."""
    from repro_torch.launch.cache_specs import cache_partition_specs, shard_cache
    from repro_torch.models import cache_init, decode_step, model_meta
    from repro_torch.parallel import comm, hints, shard_params
    from repro_torch.train import make_prefill, make_serve_step
    from repro_torch.tree import tree_map

    out = {}
    for name, case in cases.items():
        cfg = case_config(case)
        mesh = case_mesh(case)
        policy = case_policy(case, cfg, mesh)
        specs = policy.param_specs(model_meta(cfg))
        params = shard_params(params_of(inp, name), policy.param_shardings(model_meta(cfg)))
        res = policy.resolver()
        n, i = res.size("act_batch"), res.index("act_batch")
        tokens = batch_of(inp, name)["tokens"]
        rows = tokens[i * tokens.shape[0] // n:(i + 1) * tokens.shape[0] // n]
        prefill = make_prefill(cfg, policy=policy, device="cpu")(params, {"tokens": rows})
        whole = cache_init(cfg, tokens.shape[0], case["max_len"], device="cpu")
        shardings = cache_partition_specs(cfg, mesh, policy, whole)
        cache = shard_cache(whole, shardings)
        step = make_serve_step(cfg, policy=policy, device="cpu")
        picked = []
        steps = case.get("steps", default_steps)
        for t in range(steps):
            tok, cache = step(params, cache, rows[:, t:t + 1])
            picked.append(_np(tok))
        cache2 = shard_cache(cache_init(cfg, tokens.shape[0], case["max_len"], device="cpu"), shardings)
        local = tree_map(lambda t: t.to_local(), params)
        logits = []
        with torch.inference_mode(), hints.hint_resolver(res.with_params(specs)):
            for t in range(steps):
                lg, cache2 = decode_step(local, cfg, cache2, tokens=rows[:, t:t + 1])
                vocab = res.axes("act_vocab")
                if vocab:
                    lg = comm.all_gather(lg, mesh, vocab, -1)
                logits.append(_np(lg[:, 0]))
        out[name] = dict(prefill=_np(prefill), picked=np.stack(picked, 1), logits=np.stack(logits, 1),
                         rows=(i * tokens.shape[0] // n, (i + 1) * tokens.shape[0] // n),
                         cache=_whole_cache(cfg, policy, mesh, cache, shardings),
                         traffic=dict(comm.traffic))
    return out


def dryrun_ranks(cells):
    """Each dry-run cell's step run for real on this world
    (``launch.dryrun.count_cell``): rank 0's collective bytes, FLOPs and
    data-dependent loops."""
    from repro_torch.launch.dryrun import count_cell

    out = {}
    for name, cell in cells.items():
        rec = count_cell(cell["arch"], cell["shape"], device="cpu", **cell["kw"])
        out[name] = {k: rec[k] for k in ("collectives", "flops", "walk_flops", "flops_outside_loops", "hbm_bytes",
                                        "hbm_bytes_outside_loops", "data_dependent")}
    return out
