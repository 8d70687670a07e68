"""Port parity: the unfused first stage and its kernels' plain versions, CPU.

The port's plain ``syr2k`` / ``trailing_update`` (kernel D's plain version),
``panel_qr`` and ``panel_qr_householder`` (kernel E's), ``band_reduce(mode=
"unfused")`` for each ``panel_method``, ``chase_wavefront`` with its log and
``plan(tridiag="unfused")`` against the JAX package on the same numpy
inputs; the JAX side runs as its own tests run it on the CPU (Pallas in
interpret mode, or the jnp reference).

Tolerances: the JAX kernel tests' own for the kernels (2e-5 max|ref| for
syr2k, with exact symmetry; 5e-5 max(|ref|, 1) for the panel QR); integer
structure (``BandReflectors.blocks``, ``ChaseLog.row0`` with its sentinel n)
exactly; factors at atol 1e-4 as in tests/test_torch_band_reduction.py;
the chased T through its spectrum at 2e-4 of the band's scale, as
tests/test_kernels.py holds the chase; plan results as in
tests/test_torch_plan.py.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import random_psd, random_symmetric  # noqa: E402
from repro.backend import registry as jregistry  # noqa: E402
from repro.core import backtransform as jbt  # noqa: E402
from repro.core import band_reduction as jbr  # noqa: E402
from repro.core import bulge_chasing as jbc  # noqa: E402
from repro.core.panel_qr import panel_qr_geqrf as j_geqrf  # noqa: E402
from repro.core.panel_qr import panel_qr_householder as j_householder  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.panel import panel_qr_pallas  # noqa: E402
from repro.solver import EvdConfig as JaxConfig  # noqa: E402
from repro.solver import by_count as jax_by_count  # noqa: E402
from repro.solver import by_index as jax_by_index  # noqa: E402
from repro.solver import plan as jax_plan  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.backend import registry  # noqa: E402
from repro_torch.core import backtransform as tbt  # noqa: E402
from repro_torch.core import band_reduction as tbr  # noqa: E402
from repro_torch.core import bulge_chasing as tbc  # noqa: E402
from repro_torch.core.panel_qr import panel_qr_geqrf, panel_qr_householder  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.solver import EvdConfig, by_count, by_index, plan  # noqa: E402

ATOL = 1e-4
TOL_SYR2K = 2e-5
TOL_SYR2K_BF16 = 5e-2  # tests/test_kernels.py's bf16 tolerance
TOL_PANEL = 5e-5


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _band(n, b, seed):
    a = random_symmetric(np.random.default_rng(seed), n)
    i = np.arange(n)
    a[np.abs(i[:, None] - i[None, :]) > b] = 0.0
    return a


# --------------------------------------------------------------- kernel D
SYR2K_CASES = [(32, 8, 8, 8), (64, 16, 16, 8), (64, 64, 32, 32), (96, 32, 32, 16), (128, 24, 32, 8), (48, 16, 16, 16)]


@pytest.mark.parametrize("n,k,bm,bk", SYR2K_CASES)
def test_syr2k_matches_jax(n, k, bm, bk):
    rng = np.random.default_rng(n + k)
    a = rng.normal(size=(n, k)).astype(np.float32)
    b = rng.normal(size=(n, k)).astype(np.float32)
    c = random_symmetric(rng, n)
    want = _np(jops.syr2k(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), alpha=-1.0, bm=bm, bk=bk))
    got = ops.syr2k(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c), alpha=-1.0)
    np.testing.assert_allclose(_np(got), want, atol=TOL_SYR2K * float(np.abs(want).max()))
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("n,k,bm,bk", SYR2K_CASES)
def test_syr2k_bf16_matches_jax(n, k, bm, bk):
    """bf16 operands, as tests/test_kernels.py runs JAX's syr2k: both in
    bf16, held at 5e-2 max|ref| and to exact symmetry."""
    rng = np.random.default_rng(n + k)
    a = rng.normal(size=(n, k)).astype(np.float32)
    b = rng.normal(size=(n, k)).astype(np.float32)
    c = random_symmetric(rng, n)
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (a, b, c)]
    want = np.asarray(jops.syr2k(*jb, alpha=-1.0, bm=bm, bk=bk).astype(jnp.float32))
    tb = [torch.as_tensor(x).to(torch.bfloat16) for x in (a, b, c)]
    got = ops.syr2k(*tb, alpha=-1.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got.float()), want, atol=TOL_SYR2K_BF16 * float(np.abs(want).max()))
    assert torch.equal(got, got.T)


def test_syr2k_without_c_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(32, 16)).astype(np.float32)
    b = rng.normal(size=(32, 16)).astype(np.float32)
    want = _np(jops.syr2k(jnp.asarray(a), jnp.asarray(b), bm=16, bk=16))
    got = registry.resolve("syr2k", "torch")(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(_np(got), want, atol=TOL_SYR2K * float(np.abs(want).max()))
    assert torch.equal(got, got.T)


@pytest.mark.parametrize("n,k", [(40, 12), (33, 7)])
def test_trailing_update_matches_jax(n, k):
    rng = np.random.default_rng(n)
    c = random_symmetric(rng, n)
    y = rng.normal(size=(n, k)).astype(np.float32)
    z = rng.normal(size=(n, k)).astype(np.float32)
    want = _np(jops.trailing_update(jnp.asarray(c), jnp.asarray(y), jnp.asarray(z), bm=8, bk=8))
    C, Y, Z = torch.as_tensor(c), torch.as_tensor(y), torch.as_tensor(z)
    for got in (ops.trailing_update(C, Y, Z), registry.resolve("trailing_update", "torch")(C, Y, Z)):
        np.testing.assert_allclose(_np(got), want, atol=TOL_SYR2K * float(np.abs(want).max()))
        assert torch.equal(got, got.T)
    # the same update as the fused path's plain trailing phase
    np.testing.assert_allclose(_np(got), _np(ref.trailing_update_ref(C, Y, Z)), atol=1e-5 * float(np.abs(want).max()))


# --------------------------------------------------------------- kernel E
@pytest.mark.parametrize("m,b", [(16, 4), (32, 8), (24, 6), (64, 16), (8, 8)])
def test_panel_qr_matches_jax_kernel_and_householder(m, b):
    p = np.random.default_rng(m * b).normal(size=(m, b)).astype(np.float32)
    P = torch.as_tensor(p)
    got_op = ops.panel_qr(P)
    assert all(torch.equal(x, y) for x, y in zip(got_op, registry.resolve("panel_qr", "torch")(P)))
    got_hh = panel_qr_householder(P)
    for want in (panel_qr_pallas(jnp.asarray(p), interpret=True), j_householder(jnp.asarray(p))):
        for got in (got_op, got_hh):
            for g, w in zip(got, want):
                w = _np(w)
                np.testing.assert_allclose(_np(g), w, atol=TOL_PANEL * max(float(np.abs(w).max()), 1.0))


def test_panel_qr_matches_geqrf_up_to_signs():
    """beta = +|x| against LAPACK signs: the same orthogonal factor up to the
    signs of R's diagonal (tests/test_backend_dispatch.py's check)."""
    m, b = 32, 8
    p = np.random.default_rng(21).normal(size=(m, b)).astype(np.float32)
    for V1, T1, _, R1 in (ops.panel_qr(torch.as_tensor(p)), panel_qr_householder(torch.as_tensor(p))):
        for V2, T2, _, R2 in (panel_qr_geqrf(torch.as_tensor(p)), j_geqrf(jnp.asarray(p))):
            V1, T1, R1, V2, T2, R2 = map(_np, (V1, T1, R1, V2, T2, R2))
            Q1 = np.eye(m) - V1 @ T1 @ V1.T
            Q2 = np.eye(m) - V2 @ T2 @ V2.T
            d = np.sign(np.diag(R1) * np.diag(R2))
            np.testing.assert_allclose(Q1[:, :b] * d[None, :], Q2[:, :b], atol=TOL_PANEL)
            np.testing.assert_allclose(np.abs(R1), np.abs(R2), atol=TOL_PANEL)


# ------------------------------------------------------- band_reduce, unfused
@pytest.mark.parametrize("panel_method,jax_method", [("geqrf", "geqrf"), ("householder", "householder"), ("kernel", "pallas")])
def test_band_reduce_unfused_matches_jax(panel_method, jax_method):
    n, b, nb = 40, 8, 16
    a = random_symmetric(np.random.default_rng(31), n)
    with jregistry.use_backend("jnp"):
        Bj, rj = jbr.band_reduce(
            jnp.asarray(a), b, nb, panel_method=jax_method, return_reflectors=True, merge_ts=True,
            mode="unfused",
        )
    Bt, rt = tbr.band_reduce(
        torch.as_tensor(a), b, nb, panel_method=panel_method, return_reflectors=True, merge_ts=True,
        mode="unfused",
    )
    assert rt.blocks == rj.blocks and rt.b == rj.b
    np.testing.assert_allclose(_np(Bt), _np(Bj), atol=ATOL)
    np.testing.assert_allclose(_np(rt.V), _np(rj.V), atol=ATOL)
    np.testing.assert_allclose(_np(rt.T), _np(rj.T), atol=ATOL)
    for x, y in zip(rt.Tm, rj.Tm):
        np.testing.assert_allclose(_np(x), _np(y), atol=ATOL)


def test_band_reduce_unfused_equals_fused_and_form_q():
    """The two generations compute the same factorization; Q1 from form_q
    is orthogonal, reproduces A = Q1 B Q1^T and matches JAX's form_q."""
    n, b, nb = 48, 4, 16
    a = random_symmetric(np.random.default_rng(32), n)
    A = torch.as_tensor(a)
    Bu, ru = tbr.band_reduce(A, b, nb, return_reflectors=True, mode="unfused")
    Bf, rf = tbr.band_reduce(A, b, nb, return_reflectors=True)
    assert np.array_equal(_np(A), a)
    np.testing.assert_allclose(_np(Bu), _np(Bf), atol=ATOL)
    np.testing.assert_allclose(_np(ru.V), _np(rf.V), atol=ATOL)
    Q = _np(tbr.form_q(ru, n)).astype(np.float64)
    np.testing.assert_allclose(Q.T @ Q, np.eye(n), atol=1e-5)
    np.testing.assert_allclose(Q @ _np(Bu) @ Q.T, a, atol=1e-4 * float(np.abs(a).max()))
    rj = jbr.BandReflectors(V=jnp.asarray(_np(ru.V)), T=jnp.asarray(_np(ru.T)), b=b, blocks=ru.blocks)
    np.testing.assert_allclose(Q, _np(jbr.form_q(rj, n)), atol=1e-5)


def test_band_reduce_injected_update_and_modes():
    n, b, nb = 32, 4, 8
    A = torch.as_tensor(random_symmetric(np.random.default_rng(33), n))
    calls = []

    def update(C, Y, Z):
        calls.append(C.shape)
        return ref.trailing_update_ref(C, Y, Z)

    B = tbr.band_reduce(A, b, nb, syr2k_update=update)  # injection implies "unfused"
    assert calls == [(n - e.ci - e.w,) * 2 for e in tbr.build_stage_schedule(n, b, nb).entries]
    np.testing.assert_allclose(_np(B), _np(tbr.band_reduce(A, b, nb)), atol=ATOL)


# ------------------------------------------------------------ chase, unfused
@pytest.mark.parametrize("n,b", [(24, 4), (40, 8), (33, 4)])
def test_chase_wavefront_matches_jax(n, b):
    a = _band(n, b, n)
    Tj, lj = jax.jit(jbc.chase_wavefront, static_argnums=(1, 2))(jnp.asarray(a), b, True)
    Tt, lt = tbc.chase_wavefront(torch.as_tensor(a), b, True)
    assert lt.vs.shape == lj.vs.shape and lt.taus.shape == lj.taus.shape
    assert np.array_equal(_np(lt.row0), _np(lj.row0))
    inactive = _np(lt.row0) == n
    assert inactive.any() and (_np(lt.taus)[inactive] == 0).all()
    scale = float(np.abs(a).max())
    ew = lambda T: np.linalg.eigvalsh(_np(T).astype(np.float64))  # noqa: E731
    np.testing.assert_allclose(ew(Tt), ew(Tj), atol=2e-4 * scale)
    # values-only, through the unfused band_to_tridiag (the bulge_chase op)
    Tv = tbc.band_to_tridiag(torch.as_tensor(a), b, mode="unfused")
    assert torch.equal(Tv, Tt)
    Tl, ll = tbc.band_to_tridiag(torch.as_tensor(a), b, mode="unfused", return_log=True)
    assert torch.equal(Tl, Tt) and torch.equal(ll.row0, lt.row0)


def test_jax_chase_wavefront_log_through_interop():
    """A JAX chase_wavefront log has exactly A slots per wavefront: interop
    hands it over unchanged, and the port's Q2 appliers use it as JAX does."""
    n, b = 32, 4
    a = _band(n, b, 34)
    _, lj = jbc.chase_wavefront(jnp.asarray(a), b, True)
    log = interop.chase_log({"vs": lj.vs, "taus": lj.taus, "row0": lj.row0, "n": n, "b": b})
    assert np.array_equal(_np(log.vs), _np(lj.vs)) and np.array_equal(_np(log.taus), _np(lj.taus))
    assert np.array_equal(_np(log.row0), _np(lj.row0)) and log.row0.dtype == torch.int32
    X = np.random.default_rng(35).normal(size=(n, 6)).astype(np.float32)
    want = jbt.apply_q2_blocked(lj, jnp.asarray(X), group=4)
    got = tbt.apply_q2_blocked(log, torch.as_tensor(X), group=4)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


# ------------------------------------------------------------- plan, unfused
CASES = {
    "full": (EvdConfig().spectrum, JaxConfig().spectrum),
    "by_count": (by_count(8), jax_by_count(8)),
    "by_index": (by_index(3, 11), jax_by_index(3, 11)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plan_unfused_matches_jax(case):
    n = 48
    spec_t, spec_j = CASES[case]
    a = random_symmetric(np.random.default_rng(36), n)
    pt = plan(n, torch.float32, EvdConfig(spectrum=spec_t, tridiag="unfused"), device="cpu")
    pj = jax_plan(n, jnp.float32, JaxConfig(backend="jnp", spectrum=spec_j, tridiag="unfused"))
    assert pt.tridiag == "unfused" and "tridiag=unfused" in pt.describe()
    assert (pt.b, pt.nb, pt.k) == (pj.b, pj.nb, pj.k)
    wt, Vt = map(_np, pt(torch.as_tensor(a)))
    wj, Vj = map(_np, pj(jnp.asarray(a)))
    scale = float(np.abs(wj).max())
    np.testing.assert_allclose(wt, wj, atol=1e-5 * scale)
    s = np.sign(np.sum(Vt * Vj, axis=0))
    np.testing.assert_allclose(Vt * s[None, :], Vj, atol=1e-4)
    np.testing.assert_allclose(_np(pt.eigvals(torch.as_tensor(a))), wj, atol=1e-5 * scale)


def test_inverse_pth_root_unfused_matches_jax():
    n = 32
    s = random_psd(np.random.default_rng(37), n)
    cfg = EvdConfig(tridiag="unfused")
    Xt = _np(plan(n, torch.float32, cfg, device="cpu").inverse_pth_root(torch.as_tensor(s), 4))
    jcfg = JaxConfig(backend="jnp", tridiag="unfused")
    Xj = _np(jax_plan(n, jnp.float32, jcfg).inverse_pth_root(jnp.asarray(s), 4))
    np.testing.assert_allclose(Xt, Xj, atol=2e-4 * float(np.abs(Xj).max()))
    assert interop.evd_config(dataclasses.asdict(jcfg)) == dataclasses.replace(cfg, backend="torch")
