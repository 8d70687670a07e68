"""Port parity: the wavefront bulge chase (band -> tridiagonal), CPU.

The port's plain ``bulge_wavefront`` (``chase_wavefront_slices``) against
the JAX package's slice-write executor and its Pallas kernel in interpret
mode (n <= 64).  The schedule and ``ChaseLog.row0`` (sentinel n) match
exactly, inactive slots carry tau == 0 exactly; floats at atol 3e-4 (entries
up to ~20 after ~3n sequential window updates in fp32), and
the reflector vectors also at rtol 2e-3 (v = x / v0 amplifies rounding
where |v0| is small, so an entry of size ~10 carries ~1e-3 of it).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bulge_chasing as jbc  # noqa: E402
from repro.kernels.bulge import bulge_wavefront_pallas  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import bulge_chasing as tbc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

ATOL = 3e-4
VS_RTOL = 2e-3


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _band(n, b, seed):
    a = np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
    a = a + a.T
    i = np.arange(n)
    a[np.abs(i[:, None] - i[None, :]) > b] = 0.0
    return a


@pytest.mark.parametrize("n,b", [(3, 2), (16, 4), (40, 8), (64, 8), (4096, 8)])
def test_schedule_tables_equal_jax(n, b):
    assert tbc.num_wavefronts(n, b) == jbc.num_wavefronts(n, b)
    assert tbc.max_active_sweeps(n, b) == jbc.max_active_sweeps(n, b)
    assert np.array_equal(tbc._kmax_table(n, b), jbc._kmax_table(n, b))
    assert tbc._pad_sizes(n, b) == jbc._pad_sizes(n, b)


@pytest.mark.parametrize("n,b", [(24, 4), (40, 8), (33, 4)])
def test_chase_matches_jax_slices(n, b):
    a = _band(n, b, n)
    Tj, lj = jax.jit(jbc.chase_wavefront_slices, static_argnums=(1, 2))(jnp.asarray(a), b, True)
    Tt, lt = tbc.chase_wavefront_slices(torch.as_tensor(a), b, True)
    np.testing.assert_allclose(_np(Tt), _np(Tj), atol=ATOL)
    assert lt.vs.shape == lj.vs.shape and lt.taus.shape == lj.taus.shape
    assert np.array_equal(_np(lt.row0), _np(lj.row0))
    inactive = _np(lt.row0) == n
    assert inactive.any() and (_np(lt.taus)[inactive] == 0).all()
    np.testing.assert_allclose(_np(lt.taus), _np(lj.taus), atol=ATOL)
    np.testing.assert_allclose(_np(lt.vs), _np(lj.vs), rtol=VS_RTOL, atol=ATOL)
    # values-only run gives the same T
    np.testing.assert_allclose(_np(tbc.chase_wavefront_slices(torch.as_tensor(a), b)), _np(Tt), atol=0)


@pytest.mark.parametrize("group", [1, 4])
def test_chase_matches_pallas_interpret(group):
    """The Pallas kernel's log has S*G >= A slots; the first A match the
    port's and the rest are inactive (interop drops them)."""
    n, b = 32, 4
    a = _band(n, b, 7)
    Tj, (vs, taus, row0) = bulge_wavefront_pallas(
        jnp.asarray(a), b, group=group, return_log=True, interpret=True
    )
    A = tbc.max_active_sweeps(n, b)
    assert np.asarray(vs).shape[1] >= A
    lj = interop.chase_log({"vs": vs, "taus": taus, "row0": row0, "n": n, "b": b})
    Tt, lt = ops.bulge_wavefront(torch.as_tensor(a), b, return_log=True)
    np.testing.assert_allclose(_np(Tt), _np(Tj), atol=ATOL)
    assert torch.equal(lt.row0, lj.row0)
    np.testing.assert_allclose(_np(lt.taus), _np(lj.taus), atol=ATOL)
    np.testing.assert_allclose(_np(lt.vs), _np(lj.vs), rtol=VS_RTOL, atol=ATOL)


def test_chase_preserves_spectrum_and_is_tridiagonal():
    n, b = 48, 8
    a = _band(n, b, 3)
    T = _np(tbc.band_to_tridiag(torch.as_tensor(a), b))
    i = np.arange(n)
    assert (T[np.abs(i[:, None] - i[None, :]) > 1] == 0).all()
    d, e = tbc.extract_tridiag(torch.as_tensor(T))
    dj, ej = jbc.extract_tridiag(jnp.asarray(T))
    assert np.array_equal(_np(d), _np(dj)) and np.array_equal(_np(e), _np(ej))
    np.testing.assert_allclose(
        np.linalg.eigvalsh(T.astype(np.float64)), np.linalg.eigvalsh(a.astype(np.float64)), atol=1e-3
    )


def test_trivial_sizes_match_jax():
    a = _band(2, 2, 1)
    Tt, lt = tbc.chase_wavefront_slices(torch.as_tensor(a), 2, True)
    Tj, lj = jbc.chase_wavefront_slices(jnp.asarray(a), 2, True)
    assert np.array_equal(_np(Tt), _np(Tj))
    assert np.array_equal(_np(lt.row0), _np(lj.row0)) and lt.vs.shape == lj.vs.shape


def test_unported_chase_options_raise():
    """``method="sequential"`` raised until the oracle chase was ported; it
    now runs ``chase_sequential`` (held against JAX in
    tests/test_torch_methods.py), and an unknown method raises as in the
    JAX package."""
    B = torch.as_tensor(_band(16, 4, 2))
    T, log = tbc.band_to_tridiag(B, 4, method="sequential", return_log=True)
    Ts, ls = tbc.chase_sequential(B, 4, return_log=True)
    assert torch.equal(T, Ts) and torch.equal(log.row0, ls.row0) and log.vs.ndim == 2
    with pytest.raises(ValueError, match="method"):
        tbc.band_to_tridiag(B, 4, method="bogus")
    with pytest.raises(ValueError, match="method"):
        jbc.band_to_tridiag(jnp.asarray(_band(16, 4, 2)), 4, method="bogus")
