"""Port parity: ``repro_torch.optim`` against ``repro.optim``, CPU.

The same numpy inputs (from a seed) through the JAX optimizers and the
port's: ``adamw``, ``warmup_cosine``, ``clip_by_global_norm``,
``quantize_int8`` / ``dequantize_int8`` and ``ef_compress_transform`` at
float32 tolerance (1e-5 relative to the largest entry, 1e-6 for the
elementwise schedule); Shampoo's leaf plans, counts and offsets exactly on
the full llama3.2-3b shapes; one and then three ``shampoo`` updates from
one JAX-made state (``block_size=8, update_interval=2``, ``EvdConfig(b=4,
nb=8)``, the JAX side on its jnp backend), with the statistics within 1e-6
relative, the inverse roots, updates and momentum within 1e-4 of their
largest entry; and a spy on the port's ``solve_many``: one
``op="inverse_pth_root"`` call per side on refresh steps only.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import abstract_params as jax_abstract_params  # noqa: E402
from repro.models import model_meta as jax_model_meta  # noqa: E402
from repro.solver import EvdConfig as JaxConfig  # noqa: E402
from repro_torch import interop, optim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import abstract_params, model_meta  # noqa: E402
from repro_torch.solver import EvdConfig  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

TOL = 1e-5
# The packages export the function ``shampoo``, which hides the module.
jax_shampoo_mod = importlib.import_module("repro.optim.shampoo")
shampoo_mod = importlib.import_module("repro_torch.optim.shampoo")


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol, label=""):
    """Every leaf of ``got`` within ``tol`` of the largest entry of the
    matching leaf of ``want``."""
    gp, gl, _ = flatten_with_paths(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl), (label, len(gl), len(wl))
    for path, g, w in zip(gp, gl, wl):
        g, w = _np(g).astype(np.float64), np.asarray(w).astype(np.float64)
        assert g.shape == w.shape, (label, path, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err < tol, (label, path, err)


def _tree(rng):
    return {
        "w": rng.normal(size=(16, 24)).astype(np.float32),
        "stack": rng.normal(size=(3, 8, 4, 6)).astype(np.float32),
        "b": rng.normal(size=(16,)).astype(np.float32),
    }


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _port(tree):
    return interop.model_params(tree, "cpu")


# ------------------------------------------------------------- leaf plans
@pytest.mark.parametrize("block_size", [128, 32])
def test_leaf_plans_match_jax_on_full_llama(block_size):
    """Paths, plans and offsets into the (NB, bs, bs) stack equal the JAX
    package's on the full llama3.2-3b shapes (28 stacked layers, vocab
    128256): the embedding takes Adam, the norms too."""
    jopts = jopt.ShampooOptions(block_size=block_size)
    jparams = jax_abstract_params(jax_model_meta(jax_get_config("llama3.2-3b")))
    jpaths, jleaves, _ = jax_shampoo_mod._flatten_with_paths(jparams)
    jplans, offset = [], 0
    for path, leaf in zip(jpaths, jleaves):
        plan = jax_shampoo_mod._leaf_plan(path, leaf.shape, jopts)
        if plan is not None:
            plan["offset"] = offset
            offset += plan["count"]
        jplans.append(plan)

    params = abstract_params(model_meta(get_config("llama3.2-3b")))
    paths, leaves, _ = flatten_with_paths(params)
    assert all(t.device.type == "meta" for t in leaves)
    assert paths == jpaths
    assert [tuple(t.shape) for t in leaves] == [tuple(x.shape) for x in jleaves]
    plans, nb = shampoo_mod.leaf_plans(params, optim.ShampooOptions(block_size=block_size))
    assert plans == jplans and nb == offset
    by_path = dict(zip(paths, plans))
    assert by_path["['embed']"] is None and by_path["['final_norm']/['scale']"] is None
    wq = by_path["['units']/['L0_attn']/['attn']/['wq']"]
    assert (wq["batch"], wq["m"], wq["n"]) == (28, 3072, 3072)
    # The stacked norm scales are (28, 3072) leaves, 2-D: one row of blocks each.
    norm = by_path["['units']/['L0_attn']/['norm1']/['scale']"]
    assert (norm["batch"], norm["m"], norm["n"]) == (1, 28, 3072)
    if block_size == 128:  # 6144 blocks a layer's matrices, 2 x 24 its norms' row
        assert nb == 28 * 6144 + 2 * 24


# ---------------------------------------------------------------- adamw
def test_warmup_cosine_matches_jax():
    js = jopt.warmup_cosine(3e-4, warmup=7, total=100)
    ps = optim.warmup_cosine(3e-4, warmup=7, total=100)
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.array([float(js(jnp.asarray(s))) for s in steps])
    got = np.array([float(ps(torch.tensor(int(s), dtype=torch.int32))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    for max_norm in (0.5, 1e3):
        jc, jg = jopt.clip_by_global_norm(_jax(tree), max_norm)
        pc, pg = optim.clip_by_global_norm(_port(tree), max_norm)
        assert abs(float(pg) - float(jg)) < TOL * float(jg)
        _close(pc, jc, TOL, f"clip {max_norm}")
        assert abs(float(optim.global_norm(pc)) - min(float(jg), max_norm)) < 1e-4 * max_norm


def test_adamw_matches_jax_over_three_steps():
    """Three updates from one JAX-made state, each side on its own state."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    sched = dict(base_lr=1e-2, warmup=2, total=10)
    jo = jopt.adamw(jopt.warmup_cosine(**sched), grad_clip=1.0)
    po = optim.adamw(optim.warmup_cosine(**sched), grad_clip=1.0)
    jstate = jo.init(_jax(params))
    pstate = interop.adamw_state(jax.tree_util.tree_map(np.asarray, jstate))
    jp, pp = _jax(params), _port(params)
    for g in grads:
        ju, jstate = jo.update(_jax(g), jstate, jp)
        pu, pstate = po.update(_port(g), pstate, pp)
        _close(pu, ju, TOL, "adamw updates")
        jp, pp = jopt.apply_updates(jp, ju), optim.apply_updates(pp, pu)
    assert int(pstate.step) == int(jstate.step) == 3 and pstate.step.dtype == torch.int32
    _close(pp, jp, TOL, "adamw params")
    _close(pstate.mu, jstate.mu, TOL, "adamw mu")
    _close(pstate.nu, jstate.nu, TOL, "adamw nu")


# ---------------------------------------------------------- compression
def test_int8_quantization_matches_jax():
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(8, 64)) * np.logspace(-3, 2, 8)[:, None]).astype(np.float32)
    jq, js = jopt.quantize_int8(jnp.asarray(x))
    pq, ps = optim.quantize_int8(torch.as_tensor(x))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(_np(pq), np.asarray(jq))
    np.testing.assert_allclose(_np(ps), np.asarray(js), rtol=1e-6)
    back = optim.dequantize_int8(pq, ps)
    np.testing.assert_allclose(_np(back), np.asarray(jopt.dequantize_int8(jq, js)), rtol=1e-6)
    assert float((back - torch.as_tensor(x)).abs().max()) <= float(ps.max()) / 2 * (1 + 1e-6)


def test_ef_compress_matches_jax_and_carries_the_error():
    rng = np.random.default_rng(4)
    g = {"a": rng.normal(size=(4, 32)).astype(np.float32) * 1e-3,
         "v": rng.normal(size=(32,)).astype(np.float32)}
    jinit, japply = jopt.ef_compress_transform()
    pinit, papply = optim.ef_compress_transform()
    js, ps = jinit(_jax(g)), pinit(_port(g))
    total = {k: np.zeros_like(v) for k, v in g.items()}
    for _ in range(20):
        jq, js = japply(_jax(g), js)
        pq, ps = papply(_port(g), ps)
        _close(pq, jq, TOL, "ef grads")
        _close(ps.error, js.error, 1e-4, "ef error")
        for k in total:
            total[k] += _np(pq[k])
    for k in total:  # the error is carried, not lost
        np.testing.assert_allclose(total[k] / 20, g[k], atol=float(np.abs(g[k]).max()) * 0.02)


def test_multi_device_pieces_raise():
    """Without a process group the multi-device pieces raise, naming
    torch.distributed; ``precond_mesh`` is accepted (its parity on gloo
    ranks is tests/test_torch_distributed.py's)."""
    from repro_torch.launch import make_local_mesh

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="torch.distributed"):
        optim.compressed_psum(make_local_mesh(device_type="cpu"), "data", torch.zeros(4))
    # precond_mesh is accepted; its first refresh (step 1) needs the group.
    opt = optim.shampoo(1e-3, optim.ShampooOptions(block_size=8, evd=EvdConfig(b=4, nb=8), precond_mesh=["cpu"]))
    params = {"w": torch.ones(8, 8)}
    state = opt.init(params)
    with pytest.raises(RuntimeError, match="torch.distributed"):
        opt.update({"w": torch.ones(8, 8)}, state, params)


# -------------------------------------------------------------- shampoo
SH = dict(block_size=8, update_interval=2)


def _shampoo_pair(grad_clip):
    jo = jopt.shampoo(1e-2, opts=jopt.ShampooOptions(**SH, evd=JaxConfig(b=4, nb=8, backend="jnp")),
                      grad_clip=grad_clip)
    po = optim.shampoo(1e-2, opts=optim.ShampooOptions(**SH, evd=EvdConfig(b=4, nb=8)),
                       grad_clip=grad_clip)
    return jo, po


WARM = 7


def test_shampoo_matches_jax_over_one_and_three_updates(monkeypatch):
    """From one JAX-made state mid-run (7 JAX updates in, so each block's
    statistics sum several G G^T terms), one and then three more updates on
    each side: statistics within 1e-6 relative; inverse roots, updates,
    momentum and parameters within 1e-4 of their largest entry; the refresh
    is one solve_many(op="inverse_pth_root") call per side at steps 8 and 10
    (multiples of update_interval), none at step 9.

    The gradients are of scale 10 and unclipped, so every statistics block
    has max|w| > 1: below that the JAX package's inverse iteration floors
    its shift offset at 1 and misses the eigenvectors (ROADMAP Queue 3; the
    next test holds the port there against float64)."""
    calls = []
    orig = shampoo_mod.solve_many

    def spy(*a, **k):
        calls.append(k.get("op"))
        return orig(*a, **k)

    monkeypatch.setattr(shampoo_mod, "solve_many", spy)
    rng = np.random.default_rng(5)
    jo, po = _shampoo_pair(grad_clip=None)
    grad = lambda: _jax(jax.tree_util.tree_map(lambda x: 10 * x, _tree(rng)))  # noqa: E731
    jp = _jax(_tree(rng))
    jstate = jo.init(jp)
    for _ in range(WARM):
        ju, jstate = jo.update(grad(), jstate, jp)
        jp = jopt.apply_updates(jp, ju)
    pp = _port(jax.tree_util.tree_map(np.asarray, jp))
    pstate = interop.shampoo_state(jax.tree_util.tree_map(np.asarray, jstate))
    assert tuple(pstate.stats_l.shape) == tuple(jstate.stats_l.shape) == (15, 8, 8)
    assert int(pstate.step) == WARM
    per_step = []
    for i in range(3):
        g = grad()
        n0 = len(calls)
        ju, jstate = jo.update(g, jstate, jp)
        pu, pstate = po.update(_port(jax.tree_util.tree_map(np.asarray, g)), pstate, pp)
        per_step.append(calls[n0:])
        jp, pp = jopt.apply_updates(jp, ju), optim.apply_updates(pp, pu)
        label = f"step {WARM + i + 1}"
        assert float(np.linalg.eigvalsh(np.asarray(jstate.stats_l, np.float64)).max(-1).min()) > 1
        for name in ("stats_l", "stats_r"):
            _close(getattr(pstate, name), getattr(jstate, name), 1e-6, f"{label} {name}")
        for name in ("pre_l", "pre_r"):
            _close(getattr(pstate, name), getattr(jstate, name), 1e-4, f"{label} {name}")
        _close(pu, ju, 1e-4, f"{label} updates")
        _close(pstate.mu, jstate.mu, 1e-4, f"{label} mu")
        _close(pstate.nu, jstate.nu, TOL, f"{label} nu")
        _close(pp, jp, 1e-4, f"{label} params")
        assert int(pstate.step) == WARM + i + 1
    assert per_step == [["inverse_pth_root"] * 2, [], ["inverse_pth_root"] * 2]


def test_shampoo_roots_on_small_statistics_match_float64():
    """With the default grad clip the statistics are small (max|w| ~ 1e-4)
    and ill-conditioned: the port's roots against the float64 formula
    V (w + 1e-6 max|w|)^-1/4 V^T on the same statistics, each block within
    1e-4 of its largest entry."""
    rng = np.random.default_rng(6)
    params, g = _tree(rng), _tree(rng)
    _, po = _shampoo_pair(grad_clip=1.0)
    pp = _port(params)
    _, state = po.update(_port(g), po.init(pp), pp)
    for stats, pre in ((state.stats_l, state.pre_l), (state.stats_r, state.pre_r)):
        S = _np(stats).astype(np.float64)
        w, V = np.linalg.eigh(S)
        assert float(w.max()) < 1e-2
        ridge = 1e-6 * w.max(-1)
        X = (V * (np.clip(w, 0, None) + ridge[:, None])[:, None, :] ** -0.25) @ np.swapaxes(V, -1, -2)
        err = np.abs(_np(pre) - X).max((-2, -1)) / np.abs(X).max((-2, -1))
        assert float(err.max()) < 1e-4, err
