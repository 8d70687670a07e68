"""Port parity: model sharding (``repro_torch.parallel.{hints,sharding}``,
``models.partition_specs``, the attention and MoE shard modes, FSDP,
sequence parallelism, pure data parallelism, the sharded step and
checkpoints), CPU.

Rules, modes and specs need no devices: ``resolve_attn_mode`` /
``resolve_moe_mode`` for all ten archs at model sizes 1, 2, 3, 4 and 16,
``make_policy``'s two rule tables for every combination of ``fsdp``,
``sequence_parallel``, ``pure_dp`` and a ``pod`` axis (both packages'
``make_policy`` read only the mesh's axis names and sizes, so each gets a
stand-in mesh), and ``partition_specs`` of every arch's full-width meta
under each of those tables, all equal to the JAX package's exactly.

The sharded step runs on a (2, 2) ``("data", "model")`` mesh (one case,
whose RG-LRU width cut splits a head, on (1, 4)): the JAX
package in one subprocess with four fake CPU devices (``jax.jit(step,
in_shardings=(param_sh, ...))`` under ``hint_resolver``, as
tests/test_sharding_multidevice.py runs it), the port on four gloo CPU
ranks, from the same JAX-made weights (carried with ``interop``) and
batch (musicgen-large's on frame embeddings).  The starting optimizer state is tests/test_torch_train.py's (the
second moment 1, so an update is linear in the gradient).  Loss and grad
norm at 1e-4 relative, the new weights (gathered) at 1e-4 of each leaf's
largest entry and the momentum at 1e-3 of its largest entry (as
tests/test_torch_train.py holds them), against JAX; against the port's
one-process step at 1e-5 (the momentum at 1e-4).
Every rank's loss is bitwise equal, and every rank's parameter blocks have
the spec's shard shapes.

The world and the JAX subprocess run once per pytest run: under
pytest-xdist the first worker that needs them computes them under a file
lock and the others read its pickle.
"""
import dataclasses
import fcntl
import hashlib
import itertools
import json
import os
import pickle
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import torch_shard_ranks as ranks  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch import configs, interop, models  # noqa: E402
from repro_torch.parallel import run_ranks, sharding  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train.step import init_opt_state  # noqa: E402
from repro_torch.tree import flatten_with_paths, leaves, tree_map  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 4

# Each case: the smoke config with overrides, the policy's keyword
# arguments or explicit rules (the same on both sides), the optimizer.
_CAP = {"param": {"experts": None, "expert_mlp": None},
        "act": {"act_experts": None, "act_capacity": "model", "act_expert_mlp": None}}
_TP = {"param": {"experts": None, "expert_mlp": "model"},
       "act": {"act_experts": None, "act_capacity": None, "act_expert_mlp": "model"}}
_DENSE = dict(arch="llama3.2-3b", over=dict(n_heads=4, n_kv_heads=4, attn_shard_mode="heads"), S=64)
_MOE = dict(arch="granite-moe-3b-a800m", S=64)
CASES = {
    "heads": _DENSE,
    "q_heads": dict(_DENSE, over=dict(n_heads=4, n_kv_heads=1, attn_shard_mode="q_heads")),
    "cp": dict(_DENSE, over=dict(n_heads=3, n_kv_heads=3, attn_shard_mode="cp"), S=96),  # 3 query chunks on 2
    "no_fsdp": dict(_DENSE, policy=dict(fsdp=False)),
    "sequence_parallel": dict(_DENSE, policy=dict(sequence_parallel=True)),
    "microbatches": dict(_DENSE, micro=2),
    "shampoo": dict(_DENSE, opt="shampoo"),
    "ep_dense": dict(_MOE, over=dict(moe_impl="dense", attn_shard_mode="heads", moe_shard_mode="ep")),
    "ep_dropping": dict(_MOE, over=dict(moe_impl="dropping", attn_shard_mode="heads", moe_shard_mode="ep")),
    "capacity_dense": dict(_MOE, over=dict(moe_impl="dense", attn_shard_mode="heads", moe_shard_mode="capacity"),
                           rules=_CAP),
    "capacity_dropping": dict(_MOE, over=dict(moe_impl="dropping", attn_shard_mode="heads",
                                              moe_shard_mode="capacity"), rules=_CAP),
    "tp_dense": dict(_MOE, over=dict(moe_impl="dense", attn_shard_mode="heads", moe_shard_mode="tp"), rules=_TP),
    "tp_dropping": dict(_MOE, over=dict(moe_impl="dropping", attn_shard_mode="heads", moe_shard_mode="tp"),
                        rules=_TP),
    "frontend_sequence_parallel": dict(arch="musicgen-large", over=dict(attn_shard_mode="heads"),
                                       policy=dict(sequence_parallel=True), S=64),
    "pure_dp_mamba2": dict(arch="mamba2-370m", over={}, policy=dict(pure_dp=True), S=32),
    "pure_dp_recurrentgemma": dict(arch="recurrentgemma-2b", over={}, policy=dict(pure_dp=True), S=32),
    # Tensor parallelism of the mixers: heads of Mamba2, the RG-LRU width
    # (whole heads on (2, 2); on (1, 4) each rank's 16 columns cut one of
    # the two heads of 32), with sequence parallelism too.
    # Against one process they are held in float64 (``f64``): the RG-LRU's
    # zero-initialized biases move by their update alone, whose float32
    # rounding through the gates reads up to 3.3e-5 of it between the
    # two packages' own steps.
    "tp_mamba2": dict(arch="mamba2-370m", over={}, S=32, f64=True),
    "tp_mamba2_sequence_parallel": dict(arch="mamba2-370m", over={}, policy=dict(sequence_parallel=True), S=32,
                                        f64=True),
    "tp_recurrentgemma": dict(arch="recurrentgemma-2b", over=dict(attn_shard_mode="q_heads"), S=32, f64=True),
    "tp_recurrentgemma_cut_heads": dict(arch="recurrentgemma-2b", over=dict(attn_shard_mode="cp"), S=64,
                                        mesh=(1, 4), f64=True),
}

JAX_SIDE = r"""
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from repro import configs, optim
from repro.backend.compat import make_mesh
from repro.models import model_meta
from repro.parallel.hints import hint_resolver
from repro.parallel.sharding import ShardingPolicy, make_policy
from repro.solver import EvdConfig
from repro.train import make_train_step

inp, cases, out_path = dict(np.load(sys.argv[1])), json.loads(sys.argv[2]), sys.argv[3]
out = {}


def unflatten(prefix):
    tree = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            node, keys = tree, k[len(prefix):].split("/")
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = jnp.asarray(v)
    return tree


for name, case in cases.items():
    cfg = dataclasses.replace(configs.get_smoke_config(case["arch"]), **case["over"])
    mesh = make_mesh(tuple(case.get("mesh", (2, 2))), ("data", "model"))
    policy = make_policy(mesh, cfg, **case.get("policy", {}))
    if case.get("rules"):
        pr, ar = dict(policy.param_rules), dict(policy.activation_rules)
        pr.update(case["rules"].get("param", {}))
        ar.update(case["rules"].get("act", {}))
        policy = ShardingPolicy(mesh, pr, ar)
    if case.get("opt") == "shampoo":
        opt = optim.shampoo(1e-2, opts=optim.ShampooOptions(block_size=16, update_interval=10,
                                                            evd=EvdConfig(b=4, nb=8, backend="jnp")))
    else:
        opt = optim.adamw(1e-2)
    params = unflatten(name + "/params/")
    params.setdefault("rem", {})  # an empty subtree has no arrays to carry
    state = opt.init(params)
    state = state._replace(nu=jax.tree_util.tree_map(jnp.ones_like, state.nu))
    if case.get("opt") == "shampoo":
        eye = 1.5 * jnp.broadcast_to(jnp.eye(state.stats_l.shape[-1]), state.stats_l.shape)
        state = state._replace(stats_l=eye, stats_r=eye)
    batch = unflatten(name + "/batch/")
    step = make_train_step(cfg, opt, microbatches=case.get("micro", 1))
    param_sh = policy.param_shardings(model_meta(cfg, mesh.shape["model"]))
    with hint_resolver(policy.resolver()):
        p2, s2, m = jax.jit(step, in_shardings=(param_sh, None, None, None))(params, state, batch, jnp.zeros((), jnp.int32))
    for k in ("loss", "grad_norm"):
        out[f"{name}/{k}"] = m[k]
    for key, tree in (("new", p2), ("mu", s2.mu)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[f"{name}/{key}/" + "/".join(str(p.key) for p in path)] = leaf
np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
print("JAX_SIDE_OK")
"""


def _config(case):
    return ranks.case_config(case)


def _inputs():
    """Per case: JAX-made weights (seeded) and a seeded batch, flattened to
    ``name/params/...`` and ``name/batch/...`` numpy arrays."""
    inp = {}
    for i, (name, case) in enumerate(CASES.items()):
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(case["arch"]), **case["over"])
        jp = jmodels.model_params(jcfg, jax.random.PRNGKey(i))
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
            inp[f"{name}/params/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
        rng = np.random.default_rng(i)
        tokens = rng.integers(0, jcfg.vocab, size=(B, case["S"])).astype(np.int32)
        inp[f"{name}/batch/tokens"] = tokens
        inp[f"{name}/batch/labels"] = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
        if jcfg.frontend:  # the backbone trains on precomputed frame embeddings
            inp[f"{name}/batch/embeds"] = rng.normal(size=(B, case["S"], jcfg.frontend_dim)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """:func:`_runs`, once per pytest run (under xdist the first worker
    computes under a lock and the rest load its result)."""
    inp = _inputs()
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid is None:
        return _runs(tmp_path_factory, inp)
    key = hashlib.sha256(pickle.dumps((sorted(inp.items()), json.dumps(CASES, sort_keys=True)))).hexdigest()[:16]
    path = tmp_path_factory.getbasetemp().parent / f"torch_shard_{uid}_{key}.pkl"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        out = _runs(tmp_path_factory, inp)
        with open(f"{path}.tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(f"{path}.tmp", path)
        return out


def _runs(tmp_path_factory, inp):
    """The JAX side (one subprocess, started first), the port's world of
    four gloo ranks, and the port's one-process steps, run while it
    computes."""
    tmp = tmp_path_factory.mktemp("shard")
    np.savez(tmp / "inputs.npz", **inp)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(tmp / "inputs.npz"), json.dumps(CASES),
         str(tmp / "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        world = run_ranks(ranks.sharding_ranks, 4, backend="gloo", device_type="cpu",
                          args=(inp, CASES, str(tmp / "ckpt")), timeout_s=600)
        one = {name: _one_process(inp, name, case) for name, case in CASES.items()}
        whole = ranks.params_of(inp, "heads")
        back = _restore_one_process(str(tmp / "ckpt"), whole)
        stdout, stderr = jax_proc.communicate(timeout=900)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0 and "JAX_SIDE_OK" in stdout, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr}"
    return dict(jax=dict(np.load(tmp / "jax.npz")), world=world, one=one, restored_one=back, whole=whole)


def _one_process(inp, name, case):
    cfg = _config(case)
    params = ranks.params_of(inp, name)
    opt = ranks.case_optimizer(case)
    state = ranks.start_state(opt, init_opt_state(opt, params))
    new, new_state, m = make_train_step(cfg, opt, microbatches=case.get("micro", 1))(
        params, state, ranks.batch_of(inp, name), 0)
    paths = flatten_with_paths(new)[0]
    out = dict(metrics={k: float(v) for k, v in m.items()},
               params={p: t.numpy() for p, t in zip(paths, leaves(new))},
               mu={p: t.numpy() for p, t in zip(paths, leaves(new_state.mu))})
    if case.get("f64"):
        p64 = tree_map(torch.Tensor.double, params)
        n64, s64, _ = make_train_step(ranks.float64_config(cfg), opt)(
            p64, ranks.start_state(opt, init_opt_state(opt, p64)), ranks.batch_of(inp, name), 0)
        out.update(params64={p: t.numpy() for p, t in zip(paths, leaves(n64))},
                   mu64={p: t.numpy() for p, t in zip(paths, leaves(s64.mu))})
    return out


def _restore_one_process(directory, whole):
    from repro_torch.ckpt import CheckpointManager

    return CheckpointManager(directory).restore(1, {"params": whole})["params"]


def _jax_path(path):
    """``['units']/['wq']`` -> ``units/wq`` (the JAX side's key)."""
    return "/".join(p[2:-2] for p in path.split("/"))


# ------------------------------------------------------------ rules
class _Mesh:
    """A stand-in mesh for both packages' ``make_policy`` (axis names and
    sizes only)."""

    def __init__(self, shape, names):
        self.axis_names = self.mesh_dim_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.ndim = len(names)

    def size(self, i):
        return self.shape[self.axis_names[i]]


ARCHS = list(configs.ARCHS)
POLICY_FLAGS = list(itertools.product((False, True), (False, True), (False, True), (False, True)))


@pytest.mark.parametrize("arch", ARCHS)
def test_resolved_modes_equal_jax(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for m in (1, 2, 3, 4, 16):
        assert sharding.resolve_attn_mode(cfg, m) == jsharding.resolve_attn_mode(jcfg, m), (arch, m)
        assert sharding.resolve_moe_mode(cfg, m) == jsharding.resolve_moe_mode(jcfg, m), (arch, m)


def _policies(arch, fsdp, sp, pure_dp, pod):
    shape, names = ((2, 4, 16), ("pod", "data", "model")) if pod else ((4, 16), ("data", "model"))
    mesh = _Mesh(shape, names)
    kw = dict(fsdp=fsdp, sequence_parallel=sp, pure_dp=pure_dp)
    return (sharding.make_policy(mesh, configs.get_config(arch), **kw),
            jsharding.make_policy(mesh, jconfigs.get_config(arch), **kw))


@pytest.mark.parametrize("flags", POLICY_FLAGS, ids=lambda f: "fsdp{}-sp{}-puredp{}-pod{}".format(*map(int, f)))
def test_rule_tables_and_specs_equal_jax(flags):
    """Both rule tables key for key and value for value, and every arch's
    full-width ``partition_specs`` entry by entry, under each table."""
    for arch in ARCHS:
        pol, jpol = _policies(arch, *flags)
        assert pol.param_rules == jpol.param_rules, arch
        assert pol.activation_rules == jpol.activation_rules, arch
        specs = models.partition_specs(models.model_meta(configs.get_config(arch)), pol.param_rules)
        jspecs = jmodels.partition_specs(jmodels.model_meta(jconfigs.get_config(arch)), jpol.param_rules)
        paths, got, _ = flatten_with_paths(specs)
        want = jax.tree_util.tree_leaves(jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert len(got) == len(want), arch
        for path, g, w in zip(paths, got, want):
            assert tuple(g) == tuple(w), (arch, path, tuple(g), tuple(w))


def test_hints_without_a_resolver_are_the_identity():
    from repro_torch.parallel import hints

    x = torch.randn(2, 3, 4)
    assert hints.shard_hint(x, ("act_batch", "act_res_seq", None), partial="act_mlp") is x
    assert hints.tp_input(x, ("act_batch", "act_res_seq", None), "act_heads") is x
    assert hints.shared_param(x, "act_heads") is x
    seen = []
    with hints.hint_resolver(lambda x, axes, **kw: seen.append(axes) or x):
        with hints.hint_resolver(None):
            assert hints.shard_hint(x, ("a", "b", "c")) is x
        hints.shard_hint(x, ("a", "b", "c"))
    assert seen == [("a", "b", "c")] and hints.active_resolver() is None


# ------------------------------------------------------------ the sharded step
def _close_tree(got, want, tol, label):
    assert set(got) == set(want), label
    for path in got:
        g, w = np.asarray(got[path], np.float64), np.asarray(want[path], np.float64)
        assert g.shape == w.shape, (label, path)
        err = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
        assert err < tol, (label, path, err)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax_and_one_process(runs, name):
    jx, world, one = runs["jax"], runs["world"], runs["one"][name]
    got = world[0][name]
    for key in ("loss", "grad_norm"):
        want = float(jx[f"{name}/{key}"])
        assert abs(got["metrics"][key] - want) < 1e-4 * abs(want), (name, key, got["metrics"][key], want)
        assert abs(got["metrics"][key] - one["metrics"][key]) < 1e-5 * abs(one["metrics"][key]), (name, key)
    jnew = {p: jx[f"{name}/new/{_jax_path(p)}"] for p in got["params"]}
    _close_tree(got["params"], jnew, 1e-4, f"{name} vs JAX")
    if CASES[name].get("f64"):
        # Against one process in float64, where a missing or doubled sum
        # moves the momentum by its own size.  The cross entropy runs in
        # float32 whatever the dtype, its sums split differently over the
        # vocabulary's ranks, so every gradient carries ~1e-7 of float32
        # rounding: zero-initialized leaves (the biases), which move by
        # their update alone, and the momentum read up to 1.2e-6 apart.
        _close_tree(got["params64"], one["params64"], 1e-5, f"{name} vs one process, float64")
        _close_tree(got["mu64"], one["mu64"], 1e-5, f"{name} momentum vs one process, float64")
    else:
        _close_tree(got["params"], one["params"], 1e-5, f"{name} vs one process")
    # The momentum is 0.1 x the clipped gradient: a leaf's gradient that a
    # missing sum halves or drops moves it by its own size, where the
    # weights move by 2e-3 of it.  Against one process at 1e-4: the
    # one-process float32 momentum itself sits 3e-5 to 2.6e-4 of its largest
    # entry from the same step in float64 in these cases, and the sharded
    # one up to 5.1e-5 from it (heads' w_gate).
    jmu = {p: jx[f"{name}/mu/{_jax_path(p)}"] for p in got["mu"]}
    _close_tree(got["mu"], jmu, 1e-3, f"{name} momentum vs JAX")
    if not CASES[name].get("f64"):
        _close_tree(got["mu"], one["mu"], 1e-4, f"{name} momentum vs one process")
    for r, res in enumerate(world[1:], 1):  # every rank the same loss, bit for bit
        assert res[name]["loss_bits"] == got["loss_bits"], (name, r)


@pytest.mark.parametrize("name", ["heads", "q_heads", "cp", "ep_dropping", "capacity_dropping", "tp_dense",
                                  "sequence_parallel", "pure_dp_mamba2"])
def test_local_shapes_are_the_specs_shards(runs, name):
    """Every rank's blocks have the spec's shard shapes (the work is split,
    not replicated), and the shards' bytes sum to the model's over the
    mesh's copies."""
    case = CASES[name]
    cfg = _config(case)
    meta = models.model_meta(cfg)
    pol = ranks.case_policy(case, cfg, _Mesh(ranks.MESH, ("data", "model")))
    specs = flatten_with_paths(models.partition_specs(meta, pol.param_rules))
    metas = leaves(meta)
    sizes = dict(zip(("data", "model"), ranks.MESH))
    for res in runs["world"]:
        local = res[name]["local_shapes"]
        for path, spec, m in zip(specs[0], specs[1], metas):
            want = tuple(n // int(np.prod([sizes[a] for a in (e if isinstance(e, tuple) else (e,) if e else ())]))
                         for n, e in zip(m.shape, spec))
            assert local[path] == want, (name, path, local[path], want)
    if name == "heads":
        assert runs["world"][0]["heads"]["local_shapes"]["['units']/['L0_attn']/['attn']/['wq']"] == (2, 32, 2, 16)


def test_reduce_scatter_uneven_forward_and_backward(runs):
    """``comm.reduce_scatter`` of 5 columns over the model axis (ranks
    ``2 d + m`` of the (2, 2) mesh): the model group's sum, columns 0-2 on
    model rank 0 and 3-4 on 1; the backward gathers each rank's (m + 1)."""
    base = np.arange(15, dtype=np.float32).reshape(3, 5)
    for r, res in enumerate(runs["world"]):
        d, m = divmod(r, 2)
        total = (4 * d + 3) * base
        got = res["reduce_scatter"]
        np.testing.assert_array_equal(got["y"], total[:, :3] if m == 0 else total[:, 3:])
        np.testing.assert_array_equal(got["grad"], np.array([[1, 1, 1, 2, 2]] * 3, np.float32))


def test_errors(runs):
    errors = runs["world"][0]["errors"]
    assert "does not match a tensor of rank 2" in errors["hint_rank"], errors
    assert "['embed']" in errors["indivisible"] and "('model',)" in errors["indivisible"]
    for arch in ("mamba2-370m", "recurrentgemma-2b"):  # tensor parallelism of the mixers runs
        assert errors[arch].startswith("ran, loss ") and np.isfinite(float(errors[arch].split()[-1])), errors


def test_sharded_checkpoint_restores_on_another_mesh(runs):
    """A (2, 2) save restored on (1, 4) (blocks of a quarter of the model
    axis) and in one process: the saved values, exactly."""
    r14 = runs["world"][0]["restore14"]
    assert r14["equal"]
    assert (2, 64, 1, 16) in r14["local_shapes"]  # wq: 4 heads on 4 ranks
    for a, b in zip(leaves(runs["restored_one"]), leaves(runs["whole"])):
        assert torch.equal(a, b)


def test_remat_dots_equals_block_and_jax():
    """``remat="dots"``: loss and gradients equal ``"block"``'s at 1e-6 and
    JAX's ``"dots"`` at 1e-4; its backward recomputes fewer ``aten.mm``
    calls than ``"block"``'s."""
    import jax.numpy as jnp
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro import train as jtrain
    from repro_torch import train as ttrain
    from repro_torch.train.step import value_and_grad

    arch = "llama3.2-3b"
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), remat="dots")
    jp = jmodels.model_params(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab, size=(2, 64)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    (jl, _), jg = jax.value_and_grad(jtrain.make_loss_fn(jcfg), has_aux=True)(
        jp, jax.tree_util.tree_map(jnp.asarray, batch))
    params = interop.model_params(jax.tree_util.tree_map(np.asarray, jp))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}

    class CountMM(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    out, mms = {}, {}
    for remat in ("block", "dots"):
        cfg = dataclasses.replace(configs.get_smoke_config(arch), remat=remat)
        loss_fn = ttrain.make_loss_fn(cfg)
        out[remat] = value_and_grad(loss_fn, params, tb)
        xs = [p.detach().requires_grad_(True) for p in leaves(params)]
        rebuild = flatten_with_paths(params)[2]
        loss, _ = loss_fn(rebuild(xs), tb)
        with CountMM() as counter:
            torch.autograd.grad(loss, xs, allow_unused=True)
        mms[remat] = counter.n
    (lb, _), gb = out["block"]
    (ld, _), gd = out["dots"]
    assert abs(float(ld) - float(lb)) < 1e-6 * abs(float(lb))
    assert abs(float(ld) - float(jl)) < 1e-4 * abs(float(jl))
    for path, a, b, j in zip(flatten_with_paths(gd)[0], leaves(gd), leaves(gb), jax.tree_util.tree_leaves(jg)):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-6 * scale, path
        j = np.asarray(j)
        assert float(np.abs(a.numpy() - j).max()) <= 1e-4 * max(float(np.abs(j).max()), 1e-30), path
    assert mms["dots"] < mms["block"], mms
