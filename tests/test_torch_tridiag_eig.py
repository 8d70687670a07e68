"""Port parity: tridiagonal eigensolvers (bisection, inverse iteration), CPU.

The port writes the JAX package's ``lax.scan`` recurrences as Python loops
vectorized over eigenvalue lanes.  Sturm counts match exactly; eigenvalues
at atol 1e-5 · max|w|; eigenvectors sign-aligned, atol 1e-4.
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
