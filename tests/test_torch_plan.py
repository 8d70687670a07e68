"""Port parity: the plan API end to end, CPU.

``repro_torch.solver.plan(n, float32, EvdConfig(), device="cpu")`` against
the JAX package's ``plan`` (jnp backend) on the same numpy matrices: full,
``by_count`` and ``by_index`` spectra and ``inverse_pth_root``.  Resolved
blocking matches exactly; eigenvalues at atol 1e-5 · max|w|, eigenvectors
sign-aligned (as tests/test_solver_batch.py does) at atol 1e-4.  Plus the
device rule, the plan cache, the registry and the scope errors.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from conftest import random_psd, random_symmetric  # noqa: E402
from repro.solver import EvdConfig as JaxConfig  # noqa: E402
from repro.solver import by_count as jax_by_count  # noqa: E402
from repro.solver import by_index as jax_by_index  # noqa: E402
from repro.solver import plan as jax_plan  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.backend import probe, registry  # noqa: E402
from repro_torch.core.band_reduction import band_reduce  # noqa: E402
from repro_torch.solver import (  # noqa: E402
    EvdConfig,
    by_count,
    by_index,
    clear_plan_cache,
    plan,
    plan_cache_size,
    plan_for,
    resolve_blocking,
)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _pair(spectrum_t, spectrum_j):
    return EvdConfig(spectrum=spectrum_t), JaxConfig(backend="jnp", spectrum=spectrum_j)


CASES = {
    "full": (EvdConfig().spectrum, JaxConfig().spectrum),
    "by_count": (by_count(8), jax_by_count(8)),
    "by_index": (by_index(3, 11), jax_by_index(3, 11)),
}


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("case", list(CASES))
def test_plan_matches_jax(n, case):
    cfg_t, cfg_j = _pair(*CASES[case])
    a = random_symmetric(np.random.default_rng(n), n)
    pt = plan(n, torch.float32, cfg_t, device="cpu")
    pj = jax_plan(n, jnp.float32, cfg_j)
    assert (pt.b, pt.nb, pt.k, pt.bisect_iters) == (pj.b, pj.nb, pj.k, pj.bisect_iters)
    assert pt.bt_group == pj.bt_group
    wt, Vt = pt(torch.as_tensor(a))
    wj, Vj = pj(jnp.asarray(a))
    wt, Vt, wj, Vj = _np(wt), _np(Vt), _np(wj), _np(Vj)
    scale = float(np.abs(wj).max())
    np.testing.assert_allclose(wt, wj, atol=1e-5 * scale)
    s = np.sign(np.sum(Vt * Vj, axis=0))
    np.testing.assert_allclose(Vt * s[None, :], Vj, atol=1e-4)
    np.testing.assert_allclose(_np(pt.eigvals(torch.as_tensor(a))), wj, atol=1e-5 * scale)


def test_inverse_pth_root_matches_jax():
    n = 32
    s = random_psd(np.random.default_rng(4), n)
    Xt = _np(plan(n, torch.float32, EvdConfig(), device="cpu").inverse_pth_root(torch.as_tensor(s), 4))
    Xj = _np(jax_plan(n, jnp.float32, JaxConfig(backend="jnp")).inverse_pth_root(jnp.asarray(s), 4))
    np.testing.assert_allclose(Xt, Xj, atol=2e-4 * float(np.abs(Xj).max()))


def test_plan_cache_identity():
    clear_plan_cache()
    p1 = plan(32, torch.float32, EvdConfig(), device="cpu")
    assert plan(32, "float32", EvdConfig(), device=torch.device("cpu")) is p1
    assert plan_for(torch.zeros((32, 32)), EvdConfig()) is p1
    assert plan(32, torch.float32, EvdConfig(spectrum=by_count(4)), device="cpu") is not p1
    assert plan(48, torch.float32, EvdConfig(), device="cpu") is not p1
    assert plan_cache_size() == 3
    assert "b=8" in p1.describe() and "device=cpu" in p1.describe()


def test_plan_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        plan(32, torch.float32, EvdConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        probe.resolve_device(None)
    assert probe.resolve_device("cpu").type == "cpu"


def test_backend_resolution(monkeypatch):
    monkeypatch.delenv(registry.ENV_VAR, raising=False)
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "jnp")  # the JAX registry's switch: not read
    assert plan(16, torch.float32, EvdConfig(), device="cpu").backend == "torch"
    with pytest.raises(ValueError, match="CUDA device"):
        plan(16, torch.float32, EvdConfig(backend="cuda"), device="cpu")
    monkeypatch.setenv(registry.ENV_VAR, "cuda")
    assert registry.default_backend(torch.device("cpu")) == "cuda"
    monkeypatch.setenv(registry.ENV_VAR, "bogus")
    with pytest.raises(ValueError):
        registry.default_backend(torch.device("cpu"))


def test_registry_ops():
    assert registry.OPS == (
        "trailing_update", "syr2k", "fused_panel_update", "bulge_chase",
        "bulge_wavefront", "panel_qr", "backtransform_wy",
    )
    from repro_torch.kernels import library, ref

    for op in registry.OPS:
        for backend in registry.BACKENDS:
            assert callable(registry.resolve(op, backend)), (op, backend)
    # Each op is handed out in its span (backend.trace.traced_op), the op
    # itself its __wrapped__.
    assert registry.resolve("fused_panel_update", "torch").__wrapped__ is ref.fused_panel_update_ref
    assert registry.resolve("syr2k", "torch").__wrapped__ is ref.syr2k_ref
    # The cuda backend is each kernel's repro_torch operator (kernels/library.py).
    assert registry.resolve("bulge_wavefront", "cuda").__wrapped__ is library.bulge_wavefront
    assert registry.resolve("syr2k", "cuda").__wrapped__ is library.syr2k
    assert registry.resolve("trailing_update", "cuda").__wrapped__ is library.trailing_update
    assert registry.resolve("panel_qr", "cuda").__wrapped__ is library.panel_qr
    with pytest.raises(ValueError):
        registry.resolve("backtransform_wy", "pallas")


@pytest.mark.parametrize(
    "kw",
    [
        dict(method="direct"),
        dict(method="jacobi"),
        dict(chase="sequential"),
        dict(backtransform="scan"),
    ],
)
def test_unported_options_raise(kw):
    """These options raised NotImplementedError until they were ported; now
    each plans as the JAX package plans it and solves to its tolerance.
    What still raises is an option neither package has."""
    n = 32
    a = random_symmetric(np.random.default_rng(n), n)
    cfg_j = JaxConfig(backend="jnp", **kw)
    pt = plan(n, torch.float32, interop.evd_config(dataclasses.asdict(cfg_j)), device="cpu")
    pj = jax_plan(n, jnp.float32, cfg_j)
    assert (pt.method, pt.b, pt.nb, pt.bt_group) == (pj.method, pj.b, pj.nb, pj.bt_group)
    wt = _np(pt.eigvals(torch.as_tensor(a)))
    wj = _np(pj.eigvals(jnp.asarray(a)))
    np.testing.assert_allclose(wt, wj, atol=1e-5 * float(np.abs(wj).max()))
    field = next(iter(kw))
    with pytest.raises(ValueError, match=field):
        EvdConfig(**{field: "bogus"})


def test_prime_n_direct_fallback_raises():
    """At prime n blocking collapses to b = 1, and the plan routes to the
    direct method as the JAX package does (it raised before the direct
    method was ported); the two-stage band reduction itself still refuses
    an n that b does not divide."""
    dec = resolve_blocking(31, device_type="cpu")
    assert dec.b == 1 and "direct" in dec.fallback_reason
    pl = plan(31, torch.float32, EvdConfig(), device="cpu")
    assert pl.method == "direct" and pl.fallback_reason == dec.fallback_reason
    with pytest.raises(ValueError, match="multiple"):
        band_reduce(torch.zeros((31, 31)), 8)


def test_batched_operand_raises():
    pl = plan(16, torch.float32, EvdConfig(), device="cpu")
    with pytest.raises(ValueError, match="batched.*solve_many"):
        pl(torch.zeros((2, 16, 16)))
    with pytest.raises(ValueError, match="full spectrum"):
        plan(16, torch.float32, EvdConfig(spectrum=by_count(2)), device="cpu").inverse_pth_root(
            torch.eye(16), 2
        )


def test_interop_config_roundtrip():
    jcfg = JaxConfig(backend="jnp", spectrum=jax_by_count(5, largest=False), tol=1e-3, b=4)
    cfg = interop.evd_config(dataclasses.asdict(jcfg))
    assert cfg == EvdConfig(backend="torch", spectrum=by_count(5, largest=False), tol=1e-3, b=4)
    assert interop.evd_config(dataclasses.asdict(JaxConfig())) == EvdConfig()


@pytest.mark.parametrize("method", ["two_stage", "jacobi"])
@pytest.mark.parametrize("exp2", [-100, -60, 40])
def test_plan_is_scale_invariant(method, exp2):
    """A and 2^k A: the executor scales each matrix by a power of 2 near its
    largest entry, so the eigenvalues come out scaled by exactly 2^k and
    the eigenvectors bit for bit equal, down to max|A| ~ 1e-30 (unscaled,
    the squared entries of the Householder norms underflowed and the
    vectors failed below max|A| ~ 1e-16; Shampoo's statistics of clipped
    gradients go that low)."""
    rng = np.random.default_rng(11)
    A = torch.as_tensor(random_symmetric(rng, 32))
    pl = plan(32, torch.float32, EvdConfig(b=4, nb=8, method=method), device="cpu")
    w, V = pl(A)
    ws, Vs = pl(torch.ldexp(A, torch.tensor(exp2)))
    assert torch.equal(ws, torch.ldexp(w, torch.tensor(exp2))) and torch.equal(Vs, V)
