"""Port parity: the other methods, generations and wrappers, CPU.

The sequential chase and the reflector-by-reflector Q2 apply
(``chase="sequential"``, ``backtransform="scan"``), the direct method and
the plan's routing to it at odd n, parallel Jacobi, the ``repro.core``
keyword wrappers and ``tridiagonalize``, the remaining public names, and
``REPRO_TORCH_TRIDIAG``, each against the JAX package (jnp backend) on the
same numpy inputs.  Integer structure (``ChaseLog.row0``, the Jacobi pair
schedule, resolved blocking) must match exactly; floats at fp32 tolerance,
eigenvectors sign-aligned.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.solver as jsolver  # noqa: E402
from conftest import random_psd, random_symmetric  # noqa: E402
from repro.core import backtransform as jbt  # noqa: E402
from repro.core import bulge_chasing as jbc  # noqa: E402
from repro.core import direct_tridiag as jdt  # noqa: E402
from repro.core import householder as jhh  # noqa: E402
from repro.core import jacobi as jjac  # noqa: E402
from repro.core.panel_qr import panel_qr as jax_panel_qr  # noqa: E402
from repro.solver import EvdConfig as JaxConfig  # noqa: E402
from repro.solver import plan as jax_plan  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.solver as tsolver  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.backend import registry  # noqa: E402
from repro_torch.core import backtransform as tbt  # noqa: E402
from repro_torch.core import bulge_chasing as tbc  # noqa: E402
from repro_torch.core import direct_tridiag as tdt  # noqa: E402
from repro_torch.core import householder as thh  # noqa: E402
from repro_torch.core import jacobi as tjac  # noqa: E402
from repro_torch.core.panel_qr import panel_qr  # noqa: E402
from repro_torch.solver import EvdConfig, plan  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _band(n, b, seed):
    a = random_symmetric(np.random.default_rng(seed), n)
    i = np.arange(n)
    a[np.abs(i[:, None] - i[None, :]) > b] = 0.0
    return a


def _eig(T):
    return np.linalg.eigvalsh(_np(T).astype(np.float64))


def _close_eigh(wt, Vt, wj, Vj):
    wt, Vt, wj, Vj = _np(wt), _np(Vt), _np(wj), _np(Vj)
    scale = float(np.abs(wj).max())
    np.testing.assert_allclose(wt, wj, atol=1e-5 * scale)
    s = np.sign(np.sum(Vt * Vj, axis=-2, keepdims=True))
    np.testing.assert_allclose(Vt * s, Vj, atol=1e-4)


# ------------------------------------------------ sequential chase, scan Q2
@pytest.mark.parametrize("n,b", [(16, 4), (24, 8), (2, 2)])
def test_chase_sequential_matches_jax(n, b):
    a = _band(n, b, n)
    Tt, lt = tbc.chase_sequential(torch.as_tensor(a), b, return_log=True)
    Tj, lj = jbc.chase_sequential(jnp.asarray(a), b, return_log=True)
    assert np.array_equal(_np(lt.row0), _np(lj.row0))
    assert lt.vs.shape == lj.vs.shape and (lt.n, lt.b) == (lj.n, lj.b)
    # test_torch_bulge.py's tolerance: entries up to ~20 after ~3n dependent
    # window updates in fp32.
    np.testing.assert_allclose(_np(Tt), _np(Tj), atol=3e-4)
    H = lambda lg: _np(lg.taus)[:, None, None] * _np(lg.vs)[:, :, None] * _np(lg.vs)[:, None, :]  # noqa: E731
    np.testing.assert_allclose(H(lt), H(lj), atol=1e-4)
    T2 = tbc.band_to_tridiag(torch.as_tensor(a), b, method="sequential")
    assert torch.equal(T2, Tt)


@pytest.mark.parametrize("kind", ["sequential", "wavefront"])
@pytest.mark.parametrize("transpose", [False, True])
def test_apply_q2_matches_jax(kind, transpose):
    n, b = 20, 4
    a = _band(n, b, 3)
    chase = jbc.chase_sequential if kind == "sequential" else jbc.chase_wavefront
    _, lj = chase(jnp.asarray(a), b, return_log=True)
    log = interop.chase_log({k: np.asarray(getattr(lj, k)) for k in ("vs", "taus", "row0")} | dict(n=n, b=b))
    X = np.random.default_rng(4).normal(size=(n, 7)).astype(np.float32)
    got = tbc.apply_q2(log, torch.as_tensor(X), transpose=transpose)
    want = jbc.apply_q2(lj, jnp.asarray(X), transpose=transpose)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_sweep_major_log_of_a_sequential_log():
    n, b = 22, 4
    a = _band(n, b, 5)
    _, lj = jbc.chase_sequential(jnp.asarray(a), b, return_log=True)
    log = interop.chase_log({k: np.asarray(getattr(lj, k)) for k in ("vs", "taus", "row0")} | dict(n=n, b=b))
    vt, tt = tbt.sweep_major_log(log)
    vj, tj = jbt.sweep_major_log(lj)
    assert vt.shape == vj.shape
    np.testing.assert_array_equal(_np(vt), _np(vj))
    np.testing.assert_array_equal(_np(tt), _np(tj))
    # The blocked apply of the sequential log equals its scan apply.
    X = torch.as_tensor(np.random.default_rng(6).normal(size=(n, 5)).astype(np.float32))
    np.testing.assert_allclose(_np(tbt.apply_q2_blocked(log, X)), _np(tbc.apply_q2(log, X)), atol=1e-5)


# ---------------------------------------------------------- direct method
@pytest.mark.parametrize("n", [3, 17, 32])
def test_direct_tridiagonalize_matches_jax(n):
    a = random_symmetric(np.random.default_rng(n), n)
    Tt, rt = tdt.direct_tridiagonalize(torch.as_tensor(a), return_reflectors=True)
    Tj, rj = jdt.direct_tridiagonalize(jnp.asarray(a), return_reflectors=True)
    # T's entries are ill-conditioned in A (rounding in one step moves all
    # later ones), so T is held through its spectrum, its exact structure
    # and A = Q T Q^T; the appliers get JAX's own reflectors.
    i = np.arange(n)
    assert (_np(Tt)[np.abs(i[:, None] - i[None, :]) > 1] == 0).all()
    scale = float(np.abs(np.linalg.eigvalsh(a.astype(np.float64))).max())
    np.testing.assert_allclose(_eig(Tt), _eig(Tj), atol=1e-5 * scale)
    QT = tdt.apply_q_direct(rt, Tt)
    np.testing.assert_allclose(_np(tdt.apply_q_direct(rt, QT.T.contiguous())), a, atol=1e-5 * scale)
    X = np.random.default_rng(1).normal(size=(n, 4)).astype(np.float32)
    refl = tdt.DirectReflectors(V=torch.as_tensor(np.array(rj.V)), taus=torch.as_tensor(np.array(rj.taus)))
    for transpose in (False, True):
        got = tdt.apply_q_direct(refl, torch.as_tensor(X), transpose=transpose)
        want = jdt.apply_q_direct(rj, jnp.asarray(X), transpose=transpose)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    # A batch runs each matrix as alone.
    Tb = tdt.direct_tridiagonalize(torch.as_tensor(np.stack([a, 2 * a])))
    np.testing.assert_allclose(_eig(Tb[0]), _eig(Tt), atol=1e-5 * scale)
    np.testing.assert_allclose(_eig(Tb[1]), 2 * _eig(Tt), atol=2e-5 * scale)


@pytest.mark.parametrize("n", [17, 31])
def test_odd_n_routes_to_direct_as_jax_does(n):
    a = random_symmetric(np.random.default_rng(n), n)
    pt = plan(n, torch.float32, EvdConfig(), device="cpu")
    pj = jax_plan(n, jnp.float32, JaxConfig(backend="jnp"))
    assert pt.method == pj.method == "direct"
    assert (pt.b, pt.nb, pt.bt_group) == (pj.b, pj.nb, pj.bt_group)
    assert pt.fallback_reason == pj.fallback_reason and "fallback" in pt.describe()
    wt, Vt = pt(torch.as_tensor(a))
    wj, Vj = pj(jnp.asarray(a))
    _close_eigh(wt, Vt, wj, Vj)
    pd = plan(24, torch.float32, EvdConfig(method="direct"), device="cpu")
    assert pd.method == "direct" and pd.b == 0
    a24 = random_symmetric(np.random.default_rng(24), 24)
    _close_eigh(*pd(torch.as_tensor(a24)),
                *jax_plan(24, jnp.float32, JaxConfig(backend="jnp", method="direct"))(jnp.asarray(a24)))


# ---------------------------------------------------------------- Jacobi
@pytest.mark.parametrize("n", [2, 4, 10, 16])
def test_round_robin_pairs_equal_jax(n):
    assert np.array_equal(tjac.round_robin_pairs(n), jjac.round_robin_pairs(n))


def test_jacobi_odd_n_raises():
    with pytest.raises(AssertionError):
        jjac.round_robin_pairs(7)
    with pytest.raises(ValueError, match="even"):
        tjac.round_robin_pairs(7)
    with pytest.raises(ValueError, match="even"):
        plan(7, torch.float32, EvdConfig(method="jacobi"), device="cpu")(torch.eye(7))


@pytest.mark.parametrize("n", [8, 24])
def test_jacobi_eigh_matches_jax(n):
    a = random_symmetric(np.random.default_rng(n + 1), n)
    wt, Vt = tjac.jacobi_eigh(torch.as_tensor(a))
    wj, Vj = jjac.jacobi_eigh(jnp.asarray(a))
    _close_eigh(wt, Vt, wj, Vj)
    cfg = JaxConfig(backend="jnp", method="jacobi")
    pt = plan(n, torch.float32, interop.evd_config(dataclasses.asdict(cfg)), device="cpu")
    _close_eigh(*pt(torch.as_tensor(a)), *jax_plan(n, jnp.float32, cfg)(jnp.asarray(a)))
    # A batch: each matrix as alone, whatever the others need.
    wb, Vb = tjac.jacobi_eigh(torch.as_tensor(np.stack([a, np.diag(np.arange(n, dtype=np.float32))])))
    _close_eigh(wb[0], Vb[0], wt, Vt)
    assert torch.equal(wb[1], torch.arange(n, dtype=torch.float32))


# ------------------------------------------------ plan options end to end
@pytest.mark.parametrize(
    "opts",
    [dict(chase="sequential"), dict(backtransform="scan"), dict(chase="sequential", backtransform="scan"),
     dict(tridiag="unfused", chase="sequential")],
)
def test_plan_generations_match_jax(opts):
    n = 24
    a = random_symmetric(np.random.default_rng(11), n)
    cfg = JaxConfig(backend="jnp", **opts)
    pt = plan(n, torch.float32, interop.evd_config(dataclasses.asdict(cfg)), device="cpu")
    pj = jax_plan(n, jnp.float32, cfg)
    assert (pt.method, pt.b, pt.nb, pt.bt_group, pt.tridiag) == (pj.method, pj.b, pj.nb, pj.bt_group, pj.tridiag)
    _close_eigh(*pt(torch.as_tensor(a)), *pj(jnp.asarray(a)))


# ------------------------------------------------------ core wrappers
def test_core_wrappers_match_jax():
    n = 16
    rng = np.random.default_rng(12)
    a = random_symmetric(rng, n)
    s = random_psd(rng, n)
    stack = np.stack([random_symmetric(rng, n) for _ in range(3)])
    # The port through its keywords, JAX through the same config on jnp.
    kw, jkw = dict(b=4, nb=8), dict(config=JaxConfig(backend="jnp", b=4, nb=8))
    At = torch.as_tensor(a)
    _close_eigh(*tcore.eigh(At, **kw), *jcore.eigh(jnp.asarray(a), **jkw))
    np.testing.assert_allclose(_np(tcore.eigvalsh(At, **kw)), _np(jcore.eigvalsh(jnp.asarray(a), **jkw)),
                               atol=1e-5 * float(np.abs(a).max()) * 4)
    _close_eigh(*tcore.eigh_batched(torch.as_tensor(stack), **kw),
                *jcore.eigh_batched(jnp.asarray(stack), **jkw))
    wt = tcore.eigvalsh_batched(torch.as_tensor(stack), **kw)
    wj = jcore.eigvalsh_batched(jnp.asarray(stack), **jkw)
    np.testing.assert_allclose(_np(wt), _np(wj), atol=1e-5 * float(np.abs(_np(wj)).max()))
    Xt = tcore.inverse_pth_root(torch.as_tensor(s), 2, **kw)
    Xj = jcore.inverse_pth_root(jnp.asarray(s), 2, **jkw)
    np.testing.assert_allclose(_np(Xt), _np(Xj), atol=2e-4 * float(np.abs(_np(Xj)).max()))
    with pytest.raises(ValueError, match="config"):
        tcore.eigh(At, config=EvdConfig(), b=4)
    with pytest.raises(ValueError, match="config"):
        jcore.eigh(jnp.asarray(a), config=JaxConfig(), b=4)


@pytest.mark.parametrize("method,n", [("two_stage", 16), ("direct", 16), ("two_stage", 15)])
def test_tridiagonalize_matches_jax(method, n):
    a = random_symmetric(np.random.default_rng(13), n)
    dt, et, (kt, rt) = tsolver.tridiagonalize(torch.as_tensor(a), method=method, return_reflectors=True)
    dj, ej, (kj, rj) = jsolver.tridiagonalize(jnp.asarray(a), method=method, return_reflectors=True)
    assert kt == kj
    T = lambda d, e: np.diag(_np(d)) + np.diag(_np(e), 1) + np.diag(_np(e), -1)  # noqa: E731
    np.testing.assert_allclose(np.linalg.eigvalsh(T(dt, et)), np.linalg.eigvalsh(T(dj, ej)),
                               atol=1e-5 * float(np.abs(a).max()) * 4)
    if kt == "two_stage":
        assert np.array_equal(_np(rt[1].row0), _np(rj[1].row0))
        assert rt[0].blocks == rj[0].blocks
    d2, e2 = tcore.tridiagonalize(torch.as_tensor(a), method=method)
    assert torch.equal(d2, dt) and torch.equal(e2, et)


# -------------------------------------------------- remaining public names
def test_public_names_equal_jax():
    assert set(tcore.__all__) == set(jcore.__all__)
    assert set(tsolver.__all__) == set(jsolver.__all__) - {"trace_count", "tile_defaults"}
    for mod in (tcore, tsolver):
        assert all(hasattr(mod, name) for name in mod.__all__)


def test_householder_helpers_match_jax():
    rng = np.random.default_rng(14)
    x = rng.normal(size=(9,)).astype(np.float32)
    M = random_symmetric(rng, 9)
    for mask in (np.arange(9) < 6, np.arange(9) > 0):
        got = thh.house_masked(torch.as_tensor(x), torch.as_tensor(mask))
        want = jhh.house_masked(jnp.asarray(x), jnp.asarray(mask))
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-6)
    v, tau, _ = jhh.house(jnp.asarray(x))
    vt, taut = torch.as_tensor(np.array(v)), torch.as_tensor(np.array(tau))
    for name in ("apply_house_left", "apply_house_right", "apply_house_both"):
        got = getattr(thh, name)(torch.as_tensor(M), vt, taut)
        want = getattr(jhh, name)(jnp.asarray(M), v, tau)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5 * float(np.abs(M).max()))


def test_panel_qr_dispatcher_matches_jax():
    P = np.random.default_rng(15).normal(size=(24, 4)).astype(np.float32)
    for method in ("geqrf", "householder"):
        got = panel_qr(torch.as_tensor(P), method=method)
        want = jax_panel_qr(jnp.asarray(P), method=method)
        for g, w in zip(got, want):
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-5)
    # "kernel" is the panel_qr op (JAX's "pallas"), beta = +|x| as "householder".
    got = panel_qr(torch.as_tensor(P), method="kernel")
    want = jax_panel_qr(jnp.asarray(P), method="householder")
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5)
    with pytest.raises(ValueError, match="panel_method"):
        panel_qr(torch.as_tensor(P), method="pallas")


# ----------------------------------------------------- REPRO_TORCH_TRIDIAG
def test_tridiag_env_var_lands_in_the_plan_key(monkeypatch):
    monkeypatch.delenv(registry.TRIDIAG_ENV_VAR, raising=False)
    monkeypatch.setenv("REPRO_TRIDIAG", "unfused")  # the JAX package's switch: not read
    fused = plan(16, torch.float32, EvdConfig(), device="cpu")
    assert registry.default_tridiag() == "fused" and fused.tridiag == "fused"
    monkeypatch.setenv(registry.TRIDIAG_ENV_VAR, "unfused")
    unfused = plan(16, torch.float32, EvdConfig(), device="cpu")
    assert unfused.tridiag == "unfused" and unfused is not fused
    assert tsolver.batch_plan(16, 2, torch.float32, EvdConfig(), device="cpu").base is unfused
    assert plan(16, torch.float32, EvdConfig(tridiag="fused"), device="cpu").tridiag == "fused"
    a = random_symmetric(np.random.default_rng(16), 16)
    _close_eigh(*unfused(torch.as_tensor(a)), *fused(torch.as_tensor(a)))
    monkeypatch.setenv(registry.TRIDIAG_ENV_VAR, "bogus")
    with pytest.raises(ValueError, match="REPRO_TORCH_TRIDIAG"):
        plan(16, torch.float32, EvdConfig(), device="cpu")


# ------------------------------------------------------------------ scope
def test_no_not_implemented_names_queue_1_items_8_or_9():
    pattern = re.compile(r"NotImplementedError\([^)]*item (8|9)\b", re.S)
    offenders = [str(p) for p in SRC.rglob("*.py") if pattern.search(p.read_text())]
    assert not offenders, offenders
    # Items 12(a) and 12(b) are ported: no NotImplementedError names item
    # 12(b) or remat.  Item 12(c) (tensor parallelism of the recurrent
    # mixers) is raised by one helper that only the Mamba2 and RG-LRU
    # forwards call.
    raises = re.compile(r"NotImplementedError\((?:[^()]|\([^()]*\))*?(item 12\(b\)|remat)", re.S)
    assert not [str(p) for p in SRC.rglob("*.py") if raises.search(p.read_text())]
    assert "item 12" not in (SRC / "solver" / "executor.py").read_text()
    assert not [str(p) for p in SRC.rglob("*.py") if "12(b)" in p.read_text()]
    # Item 12(c) (tensor parallelism of the recurrent mixers) is ported: no
    # NotImplementedError names it and its refusal helper is gone.  Item
    # 13(e), the dry-run's Shampoo option, is ported too: no
    # NotImplementedError names it, and the dry-run names it nowhere.
    raises_c = re.compile(r"NotImplementedError\((?:[^()]|\([^()]*\))*?item 12\(c\)", re.S)
    sites = sorted(str(p.relative_to(SRC)) for p in SRC.rglob("*.py") if raises_c.search(p.read_text()))
    assert sites == [], sites
    callers = sorted(str(p.relative_to(SRC)) for p in SRC.rglob("*.py") if "refuse_mixer_tp" in p.read_text())
    assert callers == [], callers
    raises_e = re.compile(r"raise NotImplementedError\((?:[^()]|\([^()]*\))*?\b(SHAMPOO_ITEM|item 13\(e\))", re.S)
    sites = sorted(str(p.relative_to(SRC)) for p in SRC.rglob("*.py") if raises_e.search(p.read_text()))
    assert sites == [], sites
    assert "13(e)" not in (SRC / "launch" / "dryrun.py").read_text()
    bare = re.compile(r"item 12\b(?!\([abc]\))")
    assert not [str(p) for p in SRC.rglob("*.py") if bare.search(p.read_text())]
