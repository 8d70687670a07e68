"""Port parity: sharded inference (``make_prefill(policy=)``,
``make_serve_step(policy=)``, ``launch.cache_specs``), CPU.

Each case runs on four ranks, a ``("data", "model")`` mesh of (2, 2) (one
case (1, 4)): the JAX package in one subprocess with four fake CPU devices
(``jax.jit(make_prefill(cfg), in_shardings=(param_sh, batch_sh))`` and
``jax.jit(make_serve_step(cfg), in_shardings=(param_sh, cache_sh, tok_sh),
out_shardings=(None, cache_sh))`` with ``cache_partition_specs``, under
``hint_resolver``, as its dry-run lowers them), the port on four gloo CPU
ranks, from the same JAX-made weights (carried with ``interop``) and
tokens.  The prefill's greedy tokens, then ``STEPS`` teacher-forced decode
steps' greedy tokens (40 for recurrentgemma, whose 32-slot local window
wraps), and the final cache gathered leaf by leaf, against JAX's and the
port's one-process run; and each step's logits (``decode_step`` under the
policy's resolver, gathered over the vocabulary) against one process at
1e-5 of max|logits| (the sharded sums' rounding reads ~2e-6).  Tokens are
equal or, where they differ, within 1e-4 of max|logits| of the reference's
largest logit (a near tie).  Caches within 1e-4 of each leaf's largest
entry of JAX's (the decode tolerance of tests/test_torch_serve.py) and
1e-5 of one process's.

Cases: attention's ``heads`` (and with sequence parallelism, which a
one-token decode drops), ``q_heads`` with one KV head (the cache's window
split, decode context parallelism), ``cp`` (3 heads on 2 ranks: weights
whole, window split), a dropping MoE (``ep``), mamba2 (heads of the state,
channels of the conv window; the B/C window replicated, batch included, as
JAX's ``cache_partition_specs`` has it: each data rank's own rows are
compared), recurrentgemma on (2, 2) (whole RG-LRU heads a rank, MQA with
the window split) and on (1, 4) (each rank's 16 columns cut a head).

The world and the JAX subprocess run once per pytest run (a file lock
under pytest-xdist, as tests/test_torch_sharding.py).
"""
import dataclasses
import fcntl
import hashlib
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import torch_shard_ranks as ranks  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro_torch.models import cache_init, decode_step, forward  # noqa: E402
from repro_torch.parallel import run_ranks  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, STEPS = 4, 12
_DENSE = dict(arch="llama3.2-3b", S=16, max_len=16)
CASES = {
    "heads": dict(_DENSE, over=dict(n_heads=4, n_kv_heads=4, attn_shard_mode="heads")),
    "heads_sequence_parallel": dict(_DENSE, over=dict(n_heads=4, n_kv_heads=4, attn_shard_mode="heads"),
                                    policy=dict(sequence_parallel=True)),
    "q_heads_window": dict(_DENSE, over=dict(n_heads=4, n_kv_heads=1, attn_shard_mode="q_heads")),
    "cp_window": dict(_DENSE, over=dict(n_heads=3, n_kv_heads=3, attn_shard_mode="cp")),
    "moe_dropping": dict(arch="granite-moe-3b-a800m", S=16, max_len=16,
                         over=dict(moe_impl="dropping", attn_shard_mode="heads", moe_shard_mode="ep")),
    "mamba2": dict(arch="mamba2-370m", over={}, S=16, max_len=16),
    "recurrentgemma": dict(arch="recurrentgemma-2b", over=dict(attn_shard_mode="q_heads"), S=64, max_len=48,
                           steps=40),
    "recurrentgemma_cut_heads": dict(arch="recurrentgemma-2b", over=dict(attn_shard_mode="cp"), S=64,
                                     max_len=48, steps=40, mesh=(1, 4)),
}

JAX_SIDE = r"""
import dataclasses, json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.backend.compat import make_mesh
from repro.launch.cache_specs import cache_partition_specs
from repro.models import cache_init, model_meta
from repro.parallel.hints import hint_resolver
from repro.parallel.sharding import make_policy
from repro.train import make_prefill, make_serve_step

inp, cases, steps, out_path = dict(np.load(sys.argv[1])), json.loads(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
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
    params = unflatten(name + "/params/")
    params.setdefault("rem", {})
    tokens = jnp.asarray(inp[name + "/batch/tokens"])
    param_sh = policy.param_shardings(model_meta(cfg, mesh.shape["model"]))
    rows = NamedSharding(mesh, P("data", None))
    with hint_resolver(policy.resolver()):
        out[name + "/prefill"] = jax.jit(make_prefill(cfg), in_shardings=(param_sh, {"tokens": rows}))(
            params, {"tokens": tokens})
        cache = cache_init(cfg, tokens.shape[0], case["max_len"])
        cache_sh = cache_partition_specs(cfg, mesh, policy, cache)
        step = jax.jit(make_serve_step(cfg), in_shardings=(param_sh, cache_sh, rows),
                       out_shardings=(None, cache_sh), donate_argnums=(1,))
        picked = []
        for t in range(case.get("steps", steps)):
            tok, cache = step(params, cache, tokens[:, t:t + 1])
            picked.append(tok)
    out[name + "/picked"] = jnp.stack(picked, 1)
    for path, leaf in jax.tree_util.tree_flatten_with_path(cache)[0]:
        out[name + "/cache/" + "/".join(jax.tree_util.keystr((p,)) for p in path)] = leaf
np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
print("JAX_SIDE_OK")
"""


def _inputs():
    inp = {}
    for i, (name, case) in enumerate(CASES.items()):
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(case["arch"]), **case["over"])
        jp = jmodels.model_params(jcfg, jax.random.PRNGKey(100 + i))
        for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
            inp[f"{name}/params/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
        rng = np.random.default_rng(100 + i)
        inp[f"{name}/batch/tokens"] = rng.integers(0, jcfg.vocab, size=(B, case["S"])).astype(np.int32)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inp = _inputs()
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid is None:
        return _runs(tmp_path_factory, inp)
    key = hashlib.sha256(pickle.dumps((sorted(inp.items()), json.dumps(CASES, sort_keys=True)))).hexdigest()[:16]
    path = tmp_path_factory.getbasetemp().parent / f"torch_serve_sharded_{uid}_{key}.pkl"
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
    tmp = tmp_path_factory.mktemp("serve_sharded")
    np.savez(tmp / "inputs.npz", **inp)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(tmp / "inputs.npz"), json.dumps(CASES), str(STEPS),
         str(tmp / "jax.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        world = run_ranks(ranks.serve_ranks, 4, backend="gloo", device_type="cpu", args=(inp, CASES, STEPS),
                          timeout_s=600)
        one = {name: _one_process(inp, name, case) for name, case in CASES.items()}
        stdout, stderr = jax_proc.communicate(timeout=900)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0 and "JAX_SIDE_OK" in stdout, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr}"
    return dict(jax=dict(np.load(tmp / "jax.npz")), world=world, one=one)


def _one_process(inp, name, case):
    cfg = ranks.case_config(case)
    params = ranks.params_of(inp, name)
    tokens = ranks.batch_of(inp, name)["tokens"]
    cache = cache_init(cfg, B, case["max_len"], device="cpu")
    logits = []
    with torch.inference_mode():
        last = forward(params, cfg, tokens=tokens)[0][:, -1].numpy()
        for t in range(case.get("steps", STEPS)):
            lg, cache = decode_step(params, cfg, cache, tokens=tokens[:, t:t + 1])
            logits.append(lg[:, 0].numpy())
    paths, leaves, _ = flatten_with_paths(cache)
    return dict(prefill_logits=last, logits=np.stack(logits, 1),
                cache={p: t.numpy() for p, t in zip(paths, leaves)})


def _tokens_agree(got, want, logits, label):
    """Equal, or a near tie: the reference's logit at the picked token within
    1e-4 of max|logits| of its largest."""
    tol = 1e-4 * float(np.abs(logits).max())
    picked = np.take_along_axis(logits, got[..., None].astype(np.int64), -1)[..., 0]
    ok = (got == want) | (logits.max(-1) - picked <= tol)
    assert ok.all(), (label, got[~ok], want[~ok])


def _rank_rows(world, name):
    """Each rank's rows of the batch, with its result (one rank a row block)."""
    seen = {}
    for res in world:
        seen.setdefault(tuple(res[name]["rows"]), res[name])
    return sorted(seen.items())


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_prefill_and_decode_match_jax_and_one_process(runs, name):
    jx, one = runs["jax"], runs["one"][name]
    for (lo, hi), got in _rank_rows(runs["world"], name):
        _tokens_agree(got["prefill"], jx[f"{name}/prefill"][lo:hi], one["prefill_logits"][lo:hi],
                      f"{name} prefill vs JAX")
        ref = one["logits"][lo:hi]
        _tokens_agree(got["picked"], jx[f"{name}/picked"][lo:hi], ref, f"{name} decode vs JAX")
        _tokens_agree(got["picked"], ref.argmax(-1), ref, f"{name} decode vs one process")
        err = float(np.abs(got["logits"] - ref).max()) / float(np.abs(ref).max())
        assert err < 1e-5, (name, lo, err)
    for res in runs["world"]:  # every rank of a row block picks the same tokens
        assert (res[name]["picked"] == dict(_rank_rows(runs["world"], name))[tuple(res[name]["rows"])]["picked"]).all()


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_cache_matches_jax_and_one_process(runs, name):
    jx, one = runs["jax"], runs["one"][name]
    blocks = _rank_rows(runs["world"], name)
    for path, whole in one["cache"].items():
        got = blocks[0][1]["cache"][path]
        if path.endswith("['conv_bc']"):  # replicated over the batch: each rank's own rows
            stacked = got.ndim == whole.ndim and "['units']" in path
            dim = 1 if stacked else 0
            got = np.concatenate([np.take(r["cache"][path], range(lo, hi), axis=dim) for (lo, hi), r in blocks],
                                 axis=dim)
        want = jx[f"{name}/cache/{path}"]
        assert got.shape == whole.shape == want.shape, (name, path)
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-4 * scale, (name, path, "vs JAX")
        assert float(np.abs(got - whole).max()) <= 1e-5 * scale, (name, path, "vs one process")
