"""Port parity: the blocked back-transform (Q1 merge, Q2 regroup), CPU.

The port's plain ``backtransform_wy`` against the JAX reference and the
JAX Pallas kernel in interpret mode (n <= 48), both directions, full and
partial panels; ``sweep_major_log`` shapes and masks exactly.  JAX-made
chase logs come across through ``repro_torch.interop``.  Floats at atol
2e-5 (X entries are O(1); each entry passes ~n/b reflector updates).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.backend import registry as jregistry  # noqa: E402
from repro.core import backtransform as jbt  # noqa: E402
from repro.core import band_reduction as jbr  # noqa: E402
from repro.core import bulge_chasing as jbc  # noqa: E402
from repro.kernels.backtransform import backtransform_wy_pallas  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import backtransform as tbt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ATOL = 2e-5


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _jax_log(n, b, seed):
    a = np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
    a = a + a.T
    i = np.arange(n)
    a[np.abs(i[:, None] - i[None, :]) > b] = 0.0
    _, lj = jax.jit(jbc.chase_wavefront_slices, static_argnums=(1, 2))(jnp.asarray(a), b, True)
    lt = interop.chase_log({"vs": lj.vs, "taus": lj.taus, "row0": lj.row0, "n": n, "b": b})
    return lj, lt


@pytest.mark.parametrize("n,b", [(3, 2), (10, 4), (32, 4), (33, 8), (4096, 8)])
def test_sweep_shape_equals_jax(n, b):
    assert tbt._sweep_shape(n, b) == jbt._sweep_shape(n, b)


@pytest.mark.parametrize("n,b", [(24, 4), (33, 8)])
def test_sweep_major_log_matches_jax(n, b):
    lj, lt = _jax_log(n, b, n)
    vj, tj = jbt.sweep_major_log(lj)
    vt, tt = tbt.sweep_major_log(lt)
    assert vt.shape == vj.shape and tt.shape == tj.shape
    assert np.array_equal(_np(tt) == 0, _np(tj) == 0)  # same masked slots
    np.testing.assert_array_equal(_np(vt), _np(vj))   # a pure regroup: exact
    np.testing.assert_array_equal(_np(tt), _np(tj))


@pytest.mark.parametrize("m", [24, 5])
@pytest.mark.parametrize("transpose", [False, True])
def test_backtransform_wy_matches_jax(m, transpose):
    n, b = 24, 4
    lj, lt = _jax_log(n, b, 3)
    vj, tj = jbt.sweep_major_log(lj)
    vt, tt = tbt.sweep_major_log(lt)
    X = np.random.default_rng(m).normal(size=(n, m)).astype(np.float32)
    want = jbt.backtransform_wy_xla(jnp.asarray(X), vj, tj, b=b, group=2, transpose=transpose)
    got = ops.backtransform_wy(torch.as_tensor(X), vt, tt, b=b, group=2, transpose=transpose)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)
    pallas = backtransform_wy_pallas(
        jnp.asarray(X), vj, tj, b=b, group=3, transpose=transpose, interpret=True
    )
    np.testing.assert_allclose(_np(got), _np(pallas), atol=ATOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_apply_q2_blocked_matches_jax(transpose):
    n, b = 32, 8
    lj, lt = _jax_log(n, b, 4)
    X = np.random.default_rng(5).normal(size=(n, 6)).astype(np.float32)
    with jregistry.use_backend("jnp"):
        want = jbt.apply_q2_blocked(lj, jnp.asarray(X), transpose=transpose)
    got = tbt.apply_q2_blocked(lt, torch.as_tensor(X), transpose=transpose)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)
    back = tbt.apply_q2_blocked(lt, got, transpose=not transpose)
    np.testing.assert_allclose(_np(back), X, atol=ATOL)


def test_merge_band_reflectors_matches_jax():
    n, b, nb = 40, 4, 16
    a = np.random.default_rng(6).normal(size=(n, n)).astype(np.float32)
    a = a + a.T
    with jregistry.use_backend("jnp"):
        _, rj = jax.jit(lambda x: jbr.band_reduce(x, b, nb, return_reflectors=True, mode="fused"))(
            jnp.asarray(a)
        )
    rt = interop.band_reflectors({"V": rj.V, "T": rj.T, "b": b, "blocks": rj.blocks, "Tm": None})
    mj = jbt.merge_band_reflectors(rj)
    mt = tbt.merge_band_reflectors(rt)
    assert mt.blocks == mj.blocks
    for x, y in zip(mt.Tm, mj.Tm):
        np.testing.assert_allclose(_np(x), _np(y), atol=1e-5)


def test_trivial_log_is_identity():
    lt = interop.chase_log({"vs": np.zeros((1, 2)), "taus": np.zeros(1), "row0": [2], "n": 2, "b": 2})
    X = torch.ones((2, 3))
    assert torch.equal(tbt.apply_q2_blocked(lt, X), X)
