"""Port parity: the first stage (DBR band reduction, fused generation), CPU.

The port's plain ``fused_panel_update`` and ``band_reduce`` against the JAX
package on both of its backends: the jnp reference and the Pallas kernel
in interpret mode (m <= 96, the JAX tests' ceiling).  Integer structure
(the schedule, ``BandReflectors.blocks``) must match exactly; floats at
atol 1e-4 (entries are O(10); errors are fp32 rounding of length-m sums).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import random_symmetric  # noqa: E402
from repro.backend import registry as jregistry  # noqa: E402
from repro.core import backtransform as jbt  # noqa: E402
from repro.core import band_reduction as jbr  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import backtransform as tbt  # noqa: E402
from repro_torch.core import band_reduction as tbr  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ATOL = 1e-4


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize(
    "n,b,nb", [(32, 4, 8), (48, 8, 16), (40, 4, 16), (24, 4, 4), (64, 8, 64), (4096, 8, 256)]
)
def test_stage_schedule_equals_jax(n, b, nb):
    got = tbr.build_stage_schedule(n, b, nb)
    want = jbr.build_stage_schedule(n, b, nb)
    assert [dataclasses.astuple(e) for e in got.entries] == [
        dataclasses.astuple(e) for e in want.entries
    ]
    assert got.blocks == want.blocks and got.num_panels == want.num_panels


@pytest.mark.parametrize("m,b,w", [(40, 8, 32), (36, 4, 12)])
def test_fused_panel_update_matches_jax_jnp(m, b, w):
    a = random_symmetric(np.random.default_rng(m), m)
    Bj, Vj, Tj = jax.jit(jref.fused_panel_update_ref, static_argnums=(1, 2))(jnp.asarray(a), b, w)
    Bt, Vt, Tt = ref.fused_panel_update_ref(torch.tensor(a), b, w)  # in place: a copy
    np.testing.assert_allclose(_np(Bt), _np(Bj), atol=ATOL)
    np.testing.assert_allclose(_np(Vt), _np(Vj), atol=ATOL)
    np.testing.assert_allclose(_np(Tt), _np(Tj), atol=ATOL)


def test_fused_panel_update_matches_pallas_interpret():
    m, b, w = 48, 8, 24
    a = random_symmetric(np.random.default_rng(5), m)
    Bj, Vj, Tj = jops.fused_panel_update(jnp.asarray(a), b, w, bm=64, interpret=True)
    A = torch.tensor(a)
    Bt, Vt, Tt = ops.fused_panel_update(A, b, w)  # CPU tensor: the plain version, in place
    assert Bt is A
    np.testing.assert_allclose(_np(Bt), _np(Bj), atol=ATOL)
    np.testing.assert_allclose(_np(Vt), _np(Vj), atol=ATOL)
    np.testing.assert_allclose(_np(Tt), _np(Tj), atol=ATOL)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_band_reduce_matches_jax(backend):
    n, b, nb = 40, 8, 16
    a = random_symmetric(np.random.default_rng(9), n)

    def reduce(x):
        return jbr.band_reduce(x, b, nb, return_reflectors=True, merge_ts=True, mode="fused")

    with jregistry.use_backend(backend):
        Bj, rj = jax.jit(reduce)(jnp.asarray(a))
    Bt, rt = tbr.band_reduce(torch.as_tensor(a), b, nb, return_reflectors=True, merge_ts=True)
    np.testing.assert_allclose(_np(Bt), _np(Bj), atol=ATOL)
    np.testing.assert_allclose(_np(rt.V), _np(rj.V), atol=ATOL)
    np.testing.assert_allclose(_np(rt.T), _np(rj.T), atol=ATOL)
    assert rt.blocks == rj.blocks and rt.b == rj.b
    assert len(rt.Tm) == len(rj.Tm)
    for x, y in zip(rt.Tm, rj.Tm):
        np.testing.assert_allclose(_np(x), _np(y), atol=ATOL)


def test_band_reduce_leaves_input_and_is_banded():
    n, b, nb = 48, 4, 16
    a = random_symmetric(np.random.default_rng(10), n)
    A = torch.as_tensor(a)
    B = tbr.band_reduce(A, b, nb)
    assert np.array_equal(_np(A), a)
    i = np.arange(n)
    assert (_np(B)[np.abs(i[:, None] - i[None, :]) > b] == 0).all()
    np.testing.assert_allclose(
        np.linalg.eigvalsh(_np(B).astype(np.float64)),
        np.linalg.eigvalsh(a.astype(np.float64)),
        atol=1e-3,
    )


def test_band_reduce_fused_reads_the_lower_triangle():
    """The fused mode reduces A's lower triangle and its mirror: an upper
    triangle off by rounding changes no bit, and A is left as it was."""
    n, b, nb = 48, 4, 16
    a = random_symmetric(np.random.default_rng(14), n)
    lower = torch.as_tensor(a)
    A = lower.clone()
    A.triu_(1).mul_(1.0 + 2.0 ** -20).add_(lower.tril())
    A0 = A.clone()
    B, r = tbr.band_reduce(A, b, nb, return_reflectors=True, mode="fused")
    Bm, rm = tbr.band_reduce(lower, b, nb, return_reflectors=True, mode="fused")
    assert torch.equal(A, A0) and not torch.equal(A, A.mT)
    assert torch.equal(B, Bm) and torch.equal(r.V, rm.V) and torch.equal(r.T, rm.T)


@pytest.mark.parametrize("transpose", [False, True])
def test_q1_from_jax_reflectors_via_interop(transpose):
    """Feed the JAX-made BandReflectors into the port's Q1 appliers."""
    n, b, nb = 48, 8, 16
    a = random_symmetric(np.random.default_rng(12), n)
    with jregistry.use_backend("jnp"):
        _, rj = jax.jit(
            lambda x: jbr.band_reduce(x, b, nb, return_reflectors=True, mode="fused")
        )(jnp.asarray(a))
    refl = interop.band_reflectors(
        {"V": rj.V, "T": rj.T, "b": rj.b, "blocks": rj.blocks, "Tm": None}
    )
    X = np.random.default_rng(13).normal(size=(n, 7)).astype(np.float32)
    want = jbt.apply_q_left_blocked(rj, jnp.asarray(X), transpose=transpose)
    got = tbt.apply_q_left_blocked(refl, torch.as_tensor(X), transpose=transpose)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    got_scan = tbr.apply_q_left(refl, torch.as_tensor(X), transpose=transpose)
    np.testing.assert_allclose(_np(got_scan), _np(want), atol=1e-5)


def test_band_reduce_unported_modes_raise():
    """As in the JAX package: an unknown mode or panel method, and the fused
    mode beside injected phases, raise ValueError."""
    A = torch.zeros((16, 16))
    with pytest.raises(ValueError, match="mode"):
        tbr.band_reduce(A, 4, 8, mode="bogus")
    with pytest.raises(ValueError, match="unfused"):
        tbr.band_reduce(A, 4, 8, mode="fused", panel_method="householder")
    with pytest.raises(ValueError, match="unfused"):
        tbr.band_reduce(A, 4, 8, mode="fused", syr2k_update=ref.trailing_update_ref)
    with pytest.raises(ValueError, match="panel_method"):
        tbr.band_reduce(A, 4, 8, panel_method="pallas")
