"""Port parity: ``repro_torch.models.moe`` against ``repro.models.moe``, and a
MoE train step against the JAX package's, CPU.

``moe_forward`` on the same numpy weights and activations, with
granite-moe's published routing (40 experts, top-8) at d_model 64 and
expert width 32, over 2 rows of 64 tokens: capacity 16 a row, so the
dropping dispatch drops choices (checked from JAX's routing).  Outputs
at 1e-5 of their largest entry and the aux losses at 1e-5 relative in
float32 (sums in other orders); in bf16 the routing is identical (the
router's float32 logits from bf16 operands) and the outputs within 1e-2
of their largest entry (bf16 rounding of each product chain, ~2^-8).
Ties in the top-k go to the lower expert index, as ``jax.lax.top_k``
breaks them.  Then one ``make_train_step`` (AdamW) on granite-moe's smoke
config from one JAX-made state, with either MoE backend: loss, CE, both
aux terms and the grad norm at 1e-4 relative, the first moment (a tenth
of the gradient) at 1e-3 of each leaf's largest entry and the new
weights at 1e-4 (tests/test_torch_train.py's tolerances).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs, interop, optim, train  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

ARCH = "granite-moe-3b-a800m"
B, S = 2, 64


def _np(x):
    return np.asarray(x.detach().cpu().to(torch.float32) if isinstance(x, torch.Tensor) else x)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _layer(moe_impl, dtype="float32", **over):
    """Granite's routing at a small width, both packages' configs, one
    JAX-made layer of weights and a numpy input."""
    over = dict(n_experts=40, top_k=8, moe_impl=moe_impl, dtype=dtype, **over)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), **over)
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **over)
    jp = jmodels.init_params(jmoe.moe_meta(jcfg, jnp.float32), jax.random.PRNGKey(0))
    x = np.random.default_rng(0).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, interop.model_params(jax.tree_util.tree_map(np.asarray, jp)), x


@pytest.mark.parametrize("moe_impl", ["dense", "dropping"])
def test_moe_forward_matches_jax(moe_impl):
    jcfg, cfg, jp, p, x = _layer(moe_impl)
    jy, jaux = jmoe.moe_forward(jp, jcfg, jnp.asarray(x))
    y, aux = moe.moe_forward(p, cfg, torch.as_tensor(x))
    assert _rel(y, jy) < 1e-5
    for k in ("moe_lb", "moe_z"):
        assert abs(float(aux[k]) - float(jaux[k])) < 1e-5 * abs(float(jaux[k])), k
    # The dropping dispatch really drops: some expert got more choices than
    # its 16 slots in some row.
    _, jidx, _ = jmoe._router(jp, jcfg, jnp.asarray(x))
    counts = np.stack([np.bincount(r, minlength=cfg.n_experts) for r in np.asarray(jidx).reshape(B, -1)])
    assert moe._capacity(cfg, S) == 16 and counts.max() > 16
    if moe_impl == "dropping":
        dense, _ = moe.moe_forward(p, dataclasses.replace(cfg, moe_impl="dense"), torch.as_tensor(x))
        assert _rel(y, dense) > 1e-2


def test_moe_bf16_routes_as_jax():
    """bf16 activations: the router's logits are float32 products of the
    bf16 operands in both packages, so the top-8 choices agree exactly and
    their weights at 1e-6; the outputs within 1e-2 of their largest entry."""
    jcfg, cfg, jp, p, x = _layer("dropping", dtype="bfloat16")
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).to(torch.bfloat16)
    jw, jidx, _ = jmoe._router(jp, jcfg, jx)
    w, idx, _ = moe._router(p, cfg, tx)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert _rel(w, jw) < 1e-6
    jy, _ = jmoe.moe_forward(jp, jcfg, jx)
    y, _ = moe.moe_forward(p, cfg, tx)
    assert y.dtype == torch.bfloat16 and _rel(y, jy) < 1e-2


def test_top_k_ties_go_to_lower_index():
    """Exact ties (integer activations, repeated router columns, so every
    logit is exact): both packages pick the lower expert index first."""
    jcfg, cfg, jp, p, _ = _layer("dense")
    rng = np.random.default_rng(1)
    cols = rng.integers(-2, 3, size=(cfg.d_model, 5)).astype(np.float32) / 8
    router = cols[:, rng.integers(0, 5, size=cfg.n_experts)]  # 40 experts, 5 distinct columns
    x = rng.integers(-2, 3, size=(B, S, cfg.d_model)).astype(np.float32)
    jp = {**jp, "router": jnp.asarray(router)}
    p = {**p, "router": torch.as_tensor(router)}
    _, jidx, _ = jmoe._router(jp, jcfg, jnp.asarray(x))
    _, idx, _ = moe._router(p, cfg, torch.as_tensor(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_dropping_equals_dense_at_high_capacity():
    """With capacity 8x the mean load no choice is dropped, and the two
    backends agree at 1e-5 (tests/test_models.py's check of the JAX one)."""
    _, cfg, _, p, x = _layer("dropping", capacity_factor=8.0)
    y, aux = moe.moe_forward(p, cfg, torch.as_tensor(x))
    yd, auxd = moe.moe_forward(p, dataclasses.replace(cfg, moe_impl="dense"), torch.as_tensor(x))
    assert _rel(y, yd) < 1e-5 and float(aux["moe_lb"]) == float(auxd["moe_lb"])


def _close(got, want, tol, label):
    paths, gl, _ = flatten_with_paths(got)
    for path, g, w in zip(paths, gl, jax.tree_util.tree_leaves(want)):
        assert _rel(g, w) < tol, (label, path)


@pytest.mark.parametrize("moe_impl", ["dense", "dropping"])
def test_moe_train_step_matches_jax(moe_impl):
    """One AdamW step from the same weights, state (second moment 1, so the
    update is linear in the gradient) and batch."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), moe_impl=moe_impl)
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), moe_impl=moe_impl)
    jparams = jmodels.model_params(jcfg, jax.random.PRNGKey(3))
    params = interop.model_params(jax.tree_util.tree_map(np.asarray, jparams))
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, size=(4, 32)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)}
    jo, po = jopt.adamw(1e-2), optim.adamw(1e-2)
    jstate = jo.init(jparams)
    jstate = jstate._replace(nu=jax.tree_util.tree_map(jnp.ones_like, jstate.nu))
    pstate = interop.adamw_state(jax.tree_util.tree_map(np.asarray, jstate))
    jp2, js2, jm = jax.jit(jtrain.make_train_step(jcfg, jo))(
        jparams, jstate, jax.tree_util.tree_map(jnp.asarray, batch), jnp.zeros((), jnp.int32))
    pp2, ps2, pm = train.make_train_step(cfg, po)(
        params, pstate, {k: torch.as_tensor(v) for k, v in batch.items()}, 0)
    assert float(pm["moe_lb"]) > 0 and float(pm["moe_z"]) > 0
    for key in ("loss", "ce", "moe_lb", "moe_z", "grad_norm"):
        assert abs(float(pm[key]) - float(jm[key])) < 1e-4 * abs(float(jm[key])), key
    _close(ps2.mu, js2.mu, 1e-3, "momentum")
    _close(pp2, jp2, 1e-4, "weights")
