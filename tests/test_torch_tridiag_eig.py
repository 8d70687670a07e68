"""Port parity: tridiagonal eigensolvers (bisection, inverse iteration), CPU.

The port writes the JAX package's ``lax.scan`` recurrences as Python loops
vectorized over eigenvalue lanes and over leading batch dimensions (where
JAX vmaps).  Sturm counts match exactly; eigenvalues at atol 1e-5 · max|w|;
eigenvectors sign-aligned, atol 1e-4.  A bucket gives each matrix the bits
of a loop over its matrices.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import tridiag_eig as jte  # noqa: E402
from repro_torch.core import tridiag_eig as tte  # noqa: E402


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _tridiag(n, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n,)).astype(np.float32), rng.normal(size=(n - 1,)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 2, 17, 64])
def test_sturm_count_equals_jax(n):
    d, e = _tridiag(n, n)
    x = np.linspace(-4, 4, 33).astype(np.float32)
    got = tte.sturm_count(torch.as_tensor(d), torch.as_tensor(e), torch.as_tensor(x))
    want = jte.sturm_count(jnp.asarray(d), jnp.asarray(e), jnp.asarray(x))
    assert got.dtype == torch.int32
    assert np.array_equal(_np(got), _np(want))


@pytest.mark.parametrize("start,count", [(0, None), (0, 5), (30, 18), (47, 1)])
def test_eigvalsh_range_matches_jax(start, count):
    n = 48
    d, e = _tridiag(n, 5)
    got = tte.eigvalsh_tridiag_range(torch.as_tensor(d), torch.as_tensor(e), start=start, count=count)
    want = jte.eigvalsh_tridiag_range(jnp.asarray(d), jnp.asarray(e), start=start, count=count)
    scale = float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5 * scale)
    T = np.diag(d) + np.diag(e, -1) + np.diag(e, 1)
    ref = np.linalg.eigvalsh(T.astype(np.float64))[start : start + (count or n - start)]
    np.testing.assert_allclose(_np(got), ref, atol=3e-5 * scale)


def test_eigvalsh_range_rejects_bad_window():
    d, e = _tridiag(8, 1)
    with pytest.raises(ValueError):
        tte.eigvalsh_tridiag_range(torch.as_tensor(d), torch.as_tensor(e), start=6, count=4)


def test_tridiag_solve_pivoted_matches_jax():
    n, lanes = 24, 5
    d, e = _tridiag(n, 9)
    rng = np.random.default_rng(10)
    shifts = rng.normal(size=(lanes,)).astype(np.float32)
    rhs = rng.normal(size=(n, lanes)).astype(np.float32)
    dsh = d[:, None] - shifts[None, :]
    got = tte._tridiag_solve_pivoted(
        torch.as_tensor(e), torch.as_tensor(dsh), torch.as_tensor(e), torch.as_tensor(rhs)
    )
    solve = jax.vmap(jte._tridiag_solve_pivoted, in_axes=(None, 1, None, 1), out_axes=1)
    want = solve(jnp.asarray(e), jnp.asarray(dsh), jnp.asarray(e), jnp.asarray(rhs))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)
    T = np.diag(d) + np.diag(e, -1) + np.diag(e, 1)
    for j in range(lanes):
        np.testing.assert_allclose((T - shifts[j] * np.eye(n)) @ _np(got)[:, j], rhs[:, j], atol=1e-3)


@pytest.mark.parametrize("start,count", [(0, 40), (32, 8)])
def test_inverse_iteration_matches_jax(start, count):
    n = 40
    d, e = _tridiag(n, 11)
    w = jte.eigvalsh_tridiag_range(jnp.asarray(d), jnp.asarray(e), start=start, count=count)
    w_np = np.array(w)
    Vj = _np(jte.eigvecs_inverse_iteration(jnp.asarray(d), jnp.asarray(e), jnp.asarray(w_np)))
    Vt = _np(tte.eigvecs_inverse_iteration(torch.as_tensor(d), torch.as_tensor(e), torch.as_tensor(w_np)))
    s = np.sign(np.sum(Vt * Vj, axis=0))
    np.testing.assert_allclose(Vt * s[None, :], Vj, atol=1e-4)
    np.testing.assert_allclose(Vt.T @ Vt, np.eye(count), atol=1e-5)


def test_inverse_iteration_shift_offset_stays_bounded():
    """Many lanes and a large max|w|: the lane offsets must stay far below
    the eigenvalue gap (1 here), or a lane converges to a neighbour's vector
    (the JAX package's (j - m/2)·8ulp·max|w| offset reaches ~3 at j = 0)."""
    n = 200
    d = np.concatenate([np.arange(n - 1, dtype=np.float32), [3e4]]).astype(np.float32)
    e = np.full((n - 1,), 0.01, np.float32)
    w = tte.eigvalsh_tridiag_range(torch.as_tensor(d), torch.as_tensor(e))
    V = tte.eigvecs_inverse_iteration(torch.as_tensor(d), torch.as_tensor(e), w).double().numpy()
    T = np.diag(d.astype(np.float64)) + np.diag(e, -1) + np.diag(e, 1)
    resid = np.linalg.norm(T @ V - V * w.double().numpy()[None, :], axis=0)
    assert resid.max() < 0.25  # a neighbour's vector leaves a residual ~ the gap, 1


def _bucket(count, n, seed):
    """Tridiagonals of different scales and one with a zero off-diagonal,
    so each matrix has its own pivot floor and Gershgorin bracket."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(count, n)).astype(np.float32) * np.geomspace(0.01, 100, count, dtype=np.float32)[:, None]
    e = rng.normal(size=(count, n - 1)).astype(np.float32)
    e[0] = 0.0
    return torch.as_tensor(d), torch.as_tensor(e)


@pytest.mark.parametrize("n", [1, 9, 33])
@pytest.mark.parametrize("start,count", [(0, None), (2, 5)])
def test_batched_bisection_equals_loop_bit_for_bit(n, start, count):
    if start + (count or 0) > n:
        start, count = 0, None
    d, e = _bucket(5, n, n)
    got = tte.eigvalsh_tridiag_range(d, e, start=start, count=count)
    for i in range(5):
        assert torch.equal(got[i], tte.eigvalsh_tridiag_range(d[i], e[i], start=start, count=count))
    x = torch.linspace(-3, 3, 7).expand(5, 7).contiguous()
    counts = tte.sturm_count(d, e, x)
    assert all(torch.equal(counts[i], tte.sturm_count(d[i], e[i], x[i])) for i in range(5))
    # A (2, 3) batch shape: the leading dimensions are batch dimensions.
    d6, e6 = _bucket(6, n, n + 1)
    w6 = tte.eigvalsh_tridiag_range(d6.view(2, 3, n), e6.view(2, 3, n - 1), start=start, count=count)
    assert torch.equal(w6.reshape(6, -1), tte.eigvalsh_tridiag_range(d6, e6, start=start, count=count))


def test_batched_inverse_iteration_matches_loop():
    n = 24
    d, e = _bucket(4, n, 3)
    w = tte.eigvalsh_tridiag_range(d, e)
    V = tte.eigvecs_inverse_iteration(d, e, w)
    assert tuple(V.shape) == (4, n, n)
    for i in range(4):
        np.testing.assert_allclose(_np(V[i]), _np(tte.eigvecs_inverse_iteration(d[i], e[i], w[i])), atol=1e-6)


@pytest.mark.parametrize("n", [1, 16, 40])
def test_eigh_tridiag_matches_jax(n):
    d, e = _tridiag(n, n + 7)
    wt = tte.eigvalsh_tridiag(torch.as_tensor(d), torch.as_tensor(e))
    wj = jte.eigvalsh_tridiag(jnp.asarray(d), jnp.asarray(e))
    scale = float(np.abs(_np(wj)).max())
    np.testing.assert_allclose(_np(wt), _np(wj), atol=1e-5 * scale)
    lt, Vt = tte.eigh_tridiag(torch.as_tensor(d), torch.as_tensor(e))
    lj, Vj = jte.eigh_tridiag(jnp.asarray(d), jnp.asarray(e))
    np.testing.assert_allclose(_np(lt), _np(lj), atol=1e-5 * scale)
    s = np.sign(np.sum(_np(Vt) * _np(Vj), axis=0))
    np.testing.assert_allclose(_np(Vt) * s[None, :], _np(Vj), atol=1e-4)
    assert torch.equal(tte.eigh_tridiag(torch.as_tensor(d), torch.as_tensor(e), eigenvectors=False), wt)
