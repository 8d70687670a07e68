"""Port parity: Householder building blocks and the panel QR (CPU).

The port's plain versions (``repro_torch.core.householder``,
``repro_torch.core.panel_qr``, ``repro_torch.kernels.panel``) against the
JAX package on the same numpy inputs.  Tolerance: fp32 rounding of short
reductions, atol 1e-5 relative to the operand scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import householder as jhh  # noqa: E402
from repro.core.panel_qr import panel_qr_geqrf as j_geqrf  # noqa: E402
from repro.kernels.panel import panel_qr_body as j_panel_body  # noqa: E402
from repro_torch.core import householder as thh  # noqa: E402
from repro_torch.core.panel_qr import panel_qr_geqrf  # noqa: E402
from repro_torch.kernels.panel import panel_qr_body  # noqa: E402

ATOL = 1e-5


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("case", ["random", "negative_head", "zero_tail"])
def test_house_matches_jax(case):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(9,)).astype(np.float32)
    if case == "negative_head":
        x[0] = -abs(x[0]) - 1.0
    if case == "zero_tail":
        x[1:] = 0.0
    vj, tj, bj = jhh.house(jnp.asarray(x))
    vt, tt, bt = thh.house(torch.as_tensor(x))
    np.testing.assert_allclose(_np(vt), _np(vj), atol=ATOL)
    np.testing.assert_allclose(_np(tt), _np(tj), atol=ATOL)
    np.testing.assert_allclose(_np(bt), _np(bj), atol=ATOL)
    if case == "zero_tail":
        assert float(tt) == 0.0


def test_house_batched_equals_rowwise():
    x = np.random.default_rng(2).normal(size=(5, 7)).astype(np.float32)
    v, tau, beta = thh.house(torch.as_tensor(x))
    for i in range(5):
        vi, ti, bi = thh.house(torch.as_tensor(x[i]))
        assert torch.equal(v[i], vi) and torch.equal(tau[i], ti) and torch.equal(beta[i], bi)


def test_larft_and_wy_apply_match_jax():
    rng = np.random.default_rng(3)
    P = rng.normal(size=(24, 6)).astype(np.float32)
    Vj, _, tj, _ = j_geqrf(jnp.asarray(P))
    V, taus = np.array(Vj), np.array(tj)
    Tj = jhh.larft(jnp.asarray(V), jnp.asarray(taus))
    Tt = thh.larft(torch.as_tensor(V), torch.as_tensor(taus))
    np.testing.assert_allclose(_np(Tt), _np(Tj), atol=ATOL)
    M = rng.normal(size=(24, 5)).astype(np.float32)
    np.testing.assert_allclose(
        _np(thh.wy_apply_left(torch.as_tensor(M), torch.as_tensor(V), Tt)),
        _np(jhh.wy_apply_left(jnp.asarray(M), jnp.asarray(V), Tj)),
        atol=ATOL * 10,
    )
    N = rng.normal(size=(5, 24)).astype(np.float32)
    np.testing.assert_allclose(
        _np(thh.wy_apply_right(torch.as_tensor(N), torch.as_tensor(V), Tt)),
        _np(jhh.wy_apply_right(jnp.asarray(N), jnp.asarray(V), Tj)),
        atol=ATOL * 10,
    )


@pytest.mark.parametrize("m,b", [(40, 8), (17, 4), (8, 8)])
def test_panel_qr_geqrf_matches_jax(m, b):
    P = np.random.default_rng(m).normal(size=(m, b)).astype(np.float32)
    for got, want in zip(panel_qr_geqrf(torch.as_tensor(P)), j_geqrf(jnp.asarray(P))):
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL * 4)


@pytest.mark.parametrize("lapack_sign", [True, False])
def test_panel_qr_body_matches_jax(lapack_sign):
    m, b = 33, 8
    P = np.random.default_rng(7).normal(size=(m, b)).astype(np.float32)
    P[5:, 2] = 0.0  # a degenerate column: sigma == 0 -> tau == 0
    got = panel_qr_body(torch.as_tensor(P), b, lapack_sign=lapack_sign)
    want = j_panel_body(jnp.asarray(P), b, lapack_sign=lapack_sign)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL * 4)


def test_panel_qr_body_lapack_sign_matches_geqrf():
    """The kernel A panel recurrence and the plain version's geqrf factor
    with the same (LAPACK) signs, so both produce the same V, T, R."""
    P = np.random.default_rng(8).normal(size=(50, 8)).astype(np.float32)
    body = panel_qr_body(torch.as_tensor(P), 8, lapack_sign=True)
    geqrf = panel_qr_geqrf(torch.as_tensor(P))
    for g, w in zip(body, geqrf):
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL * 4)
