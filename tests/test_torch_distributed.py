"""Port parity: the multi-device EVD and Shampoo refresh, CPU.

The JAX package runs in one subprocess with four fake CPU devices
(``--xla_force_host_platform_device_count=4``, as
tests/test_sharding_multidevice.py runs it; the three- and two-device meshes
are its first devices) and writes its results to ``tmp_path`` as ``.npz``.
The port runs the same seeded numpy inputs on gloo CPU ranks through
``repro_torch.parallel.run_ranks`` (four, three for the band reduction's
local branch, two for Shampoo), meeting through a ``file://`` store.

Tolerances: ``dist_trailing_update`` / ``dist_symm_matmul`` at rtol 1e-6;
``dist_band_reduce`` within 1e-4 · max|B| (the JAX package's own test);
``solve_many(devices=)`` at tests/test_torch_batch.py's tolerances
(eigenvalues 1e-5 · max|w|, sign-aligned vectors 1e-4, roots 2e-4 ·
max|X|); Shampoo with ``precond_mesh`` at tests/test_torch_optim.py's 1e-4;
``compressed_psum`` at rtol 1e-6, against JAX's and against the int8
algorithm's value from every rank's input.  Every rank's result must be
bitwise equal.  The JAX package's own sharded solve is not bit-identical to its
unsharded one (ROADMAP Queue 3), so the port is held to JAX at tolerance
only.

The worlds and the JAX subprocess run once per pytest run: under pytest-xdist
the first worker that needs them computes them under a file lock and the
others read its pickle.
"""
import fcntl
import hashlib
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch_dist_ranks as ranks  # noqa: E402
from torch.distributed.tensor import Shard  # noqa: E402
from conftest import random_psd, random_symmetric  # noqa: E402
from repro_torch.backend.compat import make_mesh  # noqa: E402
from repro_torch.launch import make_local_mesh  # noqa: E402
from repro_torch.parallel import run_ranks  # noqa: E402
from repro_torch.solver import EvdConfig, solve_many  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = 7  # JAX Shampoo updates before the state is handed over

JAX_SIDE = r"""
import sys, warnings
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import optim as jopt
from repro.backend.compat import make_mesh
from repro.core.distributed import dist_band_reduce, dist_symm_matmul, dist_trailing_update
from repro.optim import compressed_psum
from repro.solver import EvdConfig, solve_many

inp, out_path, warm = dict(np.load(sys.argv[1])), sys.argv[2], int(sys.argv[3])
devs = jax.devices()
assert len(devs) == 4, devs
mesh4, mesh3, mesh2 = (Mesh(np.array(devs[:k]), ("x",)) for k in (4, 3, 2))
mesh22 = make_mesh((2, 2), ("data", "model"))
out = {}
A, Y, Z, V = (jnp.asarray(inp[k]) for k in ("A", "Y", "Z", "V"))
out["trail"] = dist_trailing_update(mesh4, "x", A, Y, Z)
out["symm"] = dist_symm_matmul(mesh4, "x", A, V)
band = jax.jit(dist_band_reduce, static_argnums=(0, 1, 3, 4))  # eager: ~30 s of dispatch
out["band4"], out["band3"] = band(mesh4, "x", A, 4, 16), band(mesh3, "x", A, 4, 16)

cfg = EvdConfig(backend="jnp", b=4, nb=8)
sym = {"a": jnp.asarray(inp["sym_a"]), "b": jnp.asarray(inp["sym_b"])}
psd = {"a": jnp.asarray(inp["psd_a"]), "b": jnp.asarray(inp["psd_b"])}
eigh = solve_many(sym, cfg, devices=mesh22)
eigvals = solve_many(sym, cfg, op="eigvals", devices=(mesh4, ("x",)))
roots = solve_many(psd, cfg, op="inverse_pth_root", devices=devs[:4])
for leaf in ("a", "b"):
    out[f"eigh_w_{leaf}"], out[f"eigh_V_{leaf}"] = eigh[leaf]
    out[f"eigvals_{leaf}"], out[f"roots_{leaf}"] = eigvals[leaf], roots[leaf]
out["psum"] = compressed_psum(mesh4, "x", jnp.asarray(inp["x"]))

# Shampoo with precond_mesh on two devices, from one JAX-made state.
opts = jopt.ShampooOptions(block_size=8, update_interval=2, evd=cfg, precond_mesh=(mesh2, ("x",)))
opt = jopt.shampoo(1e-2, opts=opts, grad_clip=None)
rng = np.random.default_rng(5)
tree = lambda: {"w": rng.normal(size=(16, 24)).astype(np.float32),
                "stack": rng.normal(size=(3, 8, 4, 6)).astype(np.float32),
                "b": rng.normal(size=(16,)).astype(np.float32)}
grad = lambda: {k: 10 * v for k, v in tree().items()}
params = {k: jnp.asarray(v) for k, v in tree().items()}
state = opt.init(params)
for _ in range(warm):
    u, state = opt.update({k: jnp.asarray(v) for k, v in grad().items()}, state, params)
    params = jopt.apply_updates(params, u)
for f in ("step", "stats_l", "stats_r", "pre_l", "pre_r"):
    out[f"state/{f}"] = getattr(state, f)
for f in ("mu", "nu"):
    for k, v in getattr(state, f).items():
        out[f"state/{f}/{k}"] = v
for k, v in params.items():
    out[f"params/{k}"] = v
for i in range(3):
    g = grad()
    for k, v in g.items():
        out[f"grad{i}/{k}"] = v
    u, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
    params = jopt.apply_updates(params, u)
    out[f"step{i}/pre_l"], out[f"step{i}/pre_r"] = state.pre_l, state.pre_r
    for k in params:
        out[f"step{i}/updates/{k}"], out[f"step{i}/params/{k}"] = u[k], params[k]
np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})
print("JAX_SIDE_OK")
"""


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _inputs():
    rng = np.random.default_rng(11)
    return dict(
        A=random_symmetric(rng, 64), Y=rng.normal(size=(64, 8)).astype(np.float32),
        Z=rng.normal(size=(64, 8)).astype(np.float32), V=rng.normal(size=(64, 8)).astype(np.float32),
        # Six 16s (a bucket that four ranks do not divide) and three 24s.
        sym_a=np.stack([random_symmetric(rng, 16) for _ in range(6)]),
        sym_b=np.stack([random_symmetric(rng, 24) for _ in range(3)]),
        psd_a=np.stack([random_psd(rng, 16) for _ in range(6)]),
        psd_b=np.stack([random_psd(rng, 24) for _ in range(3)]),
        x=rng.normal(size=(16, 64)).astype(np.float32),
    )


def _sub(prefix, jx):
    return {k[len(prefix):]: v for k, v in jx.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """:func:`_runs`, once per pytest run: with several xdist workers, the
    first computes under a lock shared by the run's workers and the
    rest load its result."""
    inp = _inputs()
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid is None:
        return _runs(tmp_path_factory, inp)
    key = hashlib.sha256(pickle.dumps((sorted(inp.items()), WARM))).hexdigest()[:16]
    path = tmp_path_factory.getbasetemp().parent / f"torch_dist_{uid}_{key}.pkl"
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
    """The JAX side (one subprocess, started first) and the port's three
    worlds of gloo ranks, run while it computes."""
    tmp = tmp_path_factory.mktemp("dist")
    np.savez(tmp / "inputs.npz", **inp)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SIDE), str(tmp / "inputs.npz"), str(tmp / "jax.npz"), str(WARM)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        main = run_ranks(ranks.main_ranks, 4, backend="gloo", device_type="cpu", args=(inp,), timeout_s=300)
        band3 = run_ranks(ranks.band_ranks, 3, backend="gloo", device_type="cpu", args=(inp,), timeout_s=300)
        stdout, stderr = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0 and "JAX_SIDE_OK" in stdout, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr}"
    jx = dict(np.load(tmp / "jax.npz"))
    state = {f: jx[f"state/{f}"] for f in ("step", "stats_l", "stats_r", "pre_l", "pre_r")}
    state.update(mu=_sub("state/mu/", jx), nu=_sub("state/nu/", jx))
    grads = [_sub(f"grad{i}/", jx) for i in range(3)]
    shampoo = run_ranks(ranks.shampoo_ranks, 2, backend="gloo", device_type="cpu",
                        args=(state, _sub("params/", jx), grads), timeout_s=300)
    return dict(inp=inp, jax=jx, main=main, band3=band3, shampoo=shampoo)


def _leaves(x):
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def _same_on_every_rank(results, key=None):
    """Every rank's result (or its ``key``) bitwise equal to rank 0's."""
    first = _leaves(results[0] if key is None else results[0][key])
    for r, res in enumerate(results[1:], 1):
        other = _leaves(res if key is None else res[key])
        assert len(other) == len(first)
        for a, b in zip(first, other):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), (key, r)
            else:
                assert a == b, (key, r)


def _int8_mean(xs):
    """``compressed_psum``'s value from every rank's input ``xs``, in plain
    PyTorch: each input's per-row int8 payload and float32 scale (max|row| /
    127), the payloads summed exactly, times the mean scale, over n."""
    qs, ss = [], []
    for x in xs:
        s = x.abs().amax(-1, keepdim=True).clamp(min=1e-30) / 127.0
        qs.append(torch.clamp(torch.round(x / s), -127, 127).double())
        ss.append(s.double())
    n = len(xs)
    return (sum(qs) * (sum(ss) / n) / n).numpy()


def _rel(got, want):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


# ------------------------------------------------------------------ meshes
def test_meshes_need_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_mesh((1,), ("x",), device_type="cpu")
    with pytest.raises(RuntimeError, match="torch.distributed"):
        make_local_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="torch.distributed"):
        solve_many([np.eye(4, dtype=np.float32)], EvdConfig(b=2, nb=2), devices=["cpu"], device="cpu")
    with pytest.raises(ValueError, match="length"):
        make_mesh((1, 1), ("x",), device_type="cpu")


def test_meshes_on_four_ranks(runs):
    out = runs["main"]
    for r, res in enumerate(out):
        assert res["meshes"] == [((4, 1), ("data", "model"), "cpu"), ((2, 2), ("data", "model"), "cpu"),
                                 ((4,), ("x",), "cpu")]
        # (data, model) row-major is the rank; (model, data) its transpose.
        assert res["axes_index"] == [r, (r % 2) * 2 + r // 2, r // 2, r % 2]
        wrong_world, production, model3 = res["mesh_errors"]
        assert "5 ranks, the world has 4" in wrong_world
        assert "256 ranks, the world has 4" in production
        assert "divide the world size 4" in model3


# ------------------------------------------------------------- primitives
def test_dist_trailing_update_and_symm_matmul_match_jax(runs):
    inp, jx, out = runs["inp"], runs["jax"], runs["main"]
    A, Y, Z = inp["A"], inp["Y"], inp["Z"]
    for r, res in enumerate(out):
        assert res["trail_placements"] == (Shard(0),)
        # Each rank holds its own 16 rows, computed with no communication.
        want_blk = (A - Z @ Y.T - Y @ Z.T)[16 * r : 16 * (r + 1)]
        assert _rel(res["trail_local"], want_blk) < 1e-6
        assert _rel(res["trail"], jx["trail"]) < 1e-6
        assert torch.equal(res["trail_from_dtensor"], res["trail"])
        assert torch.equal(res["trail_gathered"], res["trail"])  # comm.full_tensor, by all_gather
        assert _rel(res["symm"], jx["symm"]) < 1e-6
    for key in ("trail", "symm"):
        _same_on_every_rank(out, key)


@pytest.mark.parametrize("world", [4, 3])
def test_dist_band_reduce_matches_jax(runs, world):
    """Four ranks split every trailing block; on three, blocks whose side is
    not a multiple of 3 take the local branch (JAX: the jnp
    trailing_update)."""
    jx = runs["jax"]
    bands = [res["band"] for res in runs["main"]] if world == 4 else runs["band3"]
    assert len(bands) == world
    want = jx[f"band{world}"]
    assert _rel(bands[0], want) < 1e-4
    _same_on_every_rank(bands)
    # The band has bandwidth 4 and the spectrum of A.
    B = _np(bands[0]).astype(np.float64)
    assert np.abs(np.tril(B, -5)).max() == 0.0
    w_ref = np.linalg.eigvalsh(runs["inp"]["A"].astype(np.float64))
    assert np.abs(np.linalg.eigvalsh(B) - w_ref).max() < 3e-4 * np.abs(w_ref).max()


# ------------------------------------------------------ solve_many(devices=)
@pytest.mark.parametrize("form", ["mesh", "pair", "sequence"])
def test_solve_many_devices_matches_jax(runs, form):
    """A tree of six 16s and three 24s, all three ops, in each form of
    ``devices=`` (JAX ran eigh on its mesh, eigvals on the pair, roots on
    the device sequence; one JAX run per op stands for every form)."""
    jx, out = runs["jax"], runs["main"]
    res = out[0]
    for leaf in ("a", "b"):
        w, V = res[f"eigh_{form}"][leaf]
        wj, Vj = jx[f"eigh_w_{leaf}"], jx[f"eigh_V_{leaf}"]
        scale = float(np.abs(wj).max())
        np.testing.assert_allclose(_np(w), wj, atol=1e-5 * scale)
        s = np.sign(np.sum(_np(V) * Vj, axis=-2, keepdims=True))
        np.testing.assert_allclose(_np(V) * s, Vj, atol=1e-4)
        np.testing.assert_allclose(_np(res[f"eigvals_{form}"][leaf]), jx[f"eigvals_{leaf}"],
                                   atol=1e-5 * float(np.abs(jx[f"eigvals_{leaf}"]).max()))
        Xj = jx[f"roots_{leaf}"]
        np.testing.assert_allclose(_np(res[f"roots_{form}"][leaf]), Xj, atol=2e-4 * float(np.abs(Xj).max()))
    for op in ("eigh", "eigvals", "roots"):
        _same_on_every_rank(out, f"{op}_{form}")


def test_solve_many_devices_equals_one_process(runs):
    """The three forms give the same bits, and the sharded buckets agree
    with the one-process bucket at tolerance."""
    res = runs["main"][0]
    sym = {k: torch.as_tensor(runs["inp"][f"sym_{k}"]) for k in ("a", "b")}
    one = solve_many(sym, EvdConfig(b=4, nb=8), device="cpu")
    for form in ("pair", "sequence"):
        for a, b in zip(_leaves(res[f"eigh_{form}"]), _leaves(res["eigh_mesh"])):
            assert torch.equal(a, b), form
    for leaf in ("a", "b"):
        w, V = res["eigh_mesh"][leaf]
        np.testing.assert_allclose(_np(w), _np(one[leaf][0]), atol=1e-5 * float(one[leaf][0].abs().max()))


def test_sharded_shims_warn_and_equal_solve_many(runs):
    for res in runs["main"]:
        assert [c for c, _ in res["shim_warnings"]] == ["DeprecationWarning"] * 2
        assert all("repro_torch.solver.solve_many(..., devices=(mesh, axes))" in m for _, m in res["shim_warnings"])
        for a, b in zip(_leaves(res["shim_eigh"]), _leaves(res["shim_eigh_direct"])):
            assert torch.equal(a, b)
        assert torch.equal(res["shim_roots"], res["shim_roots_direct"])
        assert "not both" in res["shim_both"]
    _same_on_every_rank(runs["main"], "shim_roots")


# ------------------------------------------------------------------ shampoo
def test_shampoo_precond_mesh_matches_jax(runs):
    """Three updates on two ranks from one JAX-made state (steps 8-10, two
    refreshes): preconditioners, updates and parameters within 1e-4 of
    JAX's with ``precond_mesh`` on two devices; every rank bitwise equal."""
    jx, steps = runs["jax"], runs["shampoo"]
    assert len(steps) == 2
    for i in range(3):
        got = steps[0][i]
        for name in ("pre_l", "pre_r"):
            assert _rel(got[name], jx[f"step{i}/{name}"]) < 1e-4, (i, name)
        for k in ("w", "stack", "b"):
            assert _rel(got["updates"][k], jx[f"step{i}/updates/{k}"]) < 1e-4, (i, k)
            assert _rel(got["params"][k], jx[f"step{i}/params/{k}"]) < 1e-4, (i, k)
    _same_on_every_rank(steps)


# --------------------------------------------------------- compressed_psum
def test_compressed_psum_matches_jax(runs):
    want = _int8_mean([torch.as_tensor(runs["inp"]["x"])] * len(runs["main"]))
    for res in runs["main"]:
        assert _rel(res["psum"], runs["jax"]["psum"]) < 1e-6
        np.testing.assert_allclose(_np(res["psum"]), want, rtol=1e-6, atol=0)
        assert _rel(res["psum"], runs["inp"]["x"]) < 0.02  # the JAX test's gate
    _same_on_every_rank(runs["main"], "psum")


def test_compressed_psum_of_distinct_inputs_is_their_mean(runs):
    """One input a rank: every entry at rtol 1e-6 of the int8 algorithm's
    value from every rank's input; and the int8 mean within its bound of the
    float mean, half a step of the largest scale a row (each rank's
    rounding), plus the scales' spread over 127 steps, plus float32
    rounding."""
    want = _int8_mean([res["psum_own_in"] for res in runs["main"]])
    for res in runs["main"]:
        np.testing.assert_allclose(_np(res["psum_own"]), want, rtol=1e-6, atol=0)
    xs = [res["psum_own_in"].double() for res in runs["main"]]
    mean = sum(xs) / len(xs)
    scales = torch.stack([x.abs().amax(-1, keepdim=True) / 127 for x in xs])
    bound = (0.5 * scales.max(0).values + (scales.max(0).values - scales.min(0).values) * 127
             + 1e-6 * mean.abs().amax(-1, keepdim=True))  # and float32 rounding
    got = runs["main"][0]["psum_own"].double()
    assert bool(((got - mean).abs() <= bound).all())
    _same_on_every_rank(runs["main"], "psum_own")


# ---------------------------------------------------------------- run_ranks
def test_run_ranks_raises_when_a_rank_raises():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(ranks.failing_rank, 3, backend="gloo", device_type="cpu", args=(1,), timeout_s=120)
    with pytest.raises(RuntimeError, match="rank 0: exited with code 3"):
        run_ranks(ranks.dying_rank, 2, backend="gloo", device_type="cpu", args=(0,), timeout_s=120)
    with pytest.raises(ValueError, match="device_type"):
        run_ranks(ranks.failing_rank, 1, backend="gloo", device_type="tpu")
