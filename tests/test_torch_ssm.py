"""Port parity: the Mamba2 (SSD) and RG-LRU mixers
(``repro_torch.models.mamba2`` / ``.griffin``) against the JAX package's
(``repro.models.mamba2`` / ``.griffin``), CPU, float32.

The same numpy inputs, made from a seed, go through both packages.
``ssd_chunked`` at 1e-5 of max|y| against JAX's and at 5e-5 against the
port's own sequential ``ssd_reference`` (tests/test_models.py's
tolerance), with S a multiple of the chunk, ragged (Q the largest divisor
of S below the chunk) and shorter than it; its gradient finite and at
5e-4 of JAX's ``jax.grad``, on decays steep enough that the masked
triangle's exponent overflows.  The Mamba2 and RG-LRU blocks of the smoke
configs (JAX-made weights carried with ``interop``): the forward at 1e-5,
the one-token decode step by step at 1e-5 with its caches, the RG-LRU
forward at S = 1056 (three chunks of 352: the checkpointed carry) against
JAX at 1e-5 with gradients at 5e-4, and against the port's own stepwise
decode at tests/test_perf_features.py's 5e-4.  The three init laws
(``lru_a``, ``ssm_alog``, ``ssm_dtbias``): ranges and moments.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import griffin as jgriffin  # noqa: E402
from repro.models import mamba2 as jmamba2  # noqa: E402
from repro.models import params as jparams_mod  # noqa: E402
from repro_torch import configs, interop  # noqa: E402
from repro_torch.models import griffin, mamba2  # noqa: E402
from repro_torch.models.params import ParamMeta, init_params  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _ssd_inputs(S, seed=0, steep=False):
    """(X, dt, A, Bm, Cm) as numpy: tests/test_models.py's draws, or with
    ``steep`` dt up to 1 and A down to -8 (dt A cumsums of hundreds)."""
    rng = np.random.default_rng(seed)
    B_, H, P, G, N = 2, 4, 8, 2, 8
    hi_dt, hi_a = (1.0, 8.0) if steep else (0.1, 4.0)
    return (rng.normal(size=(B_, S, H, P)).astype(np.float32),
            rng.uniform(0.001, hi_dt, size=(B_, S, H)).astype(np.float32),
            -rng.uniform(0.5, hi_a, size=(H,)).astype(np.float32),
            rng.normal(size=(B_, S, G, N)).astype(np.float32),
            rng.normal(size=(B_, S, G, N)).astype(np.float32))


@pytest.mark.parametrize("S", [48, 45, 7])
def test_ssd_chunked_matches_jax_and_reference(S):
    """S = 48: three chunks of 16; 45: Q = 15; 7: one chunk shorter than 16."""
    ins = _ssd_inputs(S)
    want = jmamba2.ssd_chunked(*map(jnp.asarray, ins), 16)
    t = [torch.as_tensor(x) for x in ins]
    got = mamba2.ssd_chunked(*t, 16)
    assert got.dtype == torch.float32
    assert _rel(got, want) < 1e-5
    assert _rel(got, mamba2.ssd_reference(*t)) < 5e-5
    assert _rel(mamba2.ssd_reference(*t), jmamba2.ssd_reference(*map(jnp.asarray, ins))) < 1e-5


def test_ssd_chunked_gradient_matches_jax():
    """d/d(X, dt, A, B, C) of sum(y * go): finite where a mask applied to
    exp's result would give 0 * inf, and at 5e-4 of JAX's."""
    ins = _ssd_inputs(40, seed=1, steep=True)
    go = np.random.default_rng(2).normal(size=ins[0].shape).astype(np.float32)
    jgrads = jax.grad(lambda *a: jnp.sum(jmamba2.ssd_chunked(*a, 16) * go), argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, ins))
    xs = [torch.tensor(x, requires_grad=True) for x in ins]
    grads = torch.autograd.grad((mamba2.ssd_chunked(*xs, 16) * torch.as_tensor(go)).sum(), xs)
    for g, w in zip(grads, jgrads):
        assert bool(torch.isfinite(g).all())
        assert _rel(g, w) < 5e-4


def _block(meta_fn, jmeta_fn, arch, seed):
    """A mixer's smoke-config weights, JAX-made, on both sides."""
    cfg, jcfg = configs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
    jp = jparams_mod.init_params(jmeta_fn(jcfg, jnp.float32), jax.random.PRNGKey(seed))
    p = interop.model_params(jax.tree_util.tree_map(np.asarray, jp))
    assert [m.shape for m in flatten_with_paths(meta_fn(cfg, torch.float32))[1]] == [
        np.shape(a) for a in jax.tree_util.tree_leaves(jp)]
    return cfg, jcfg, p, jp


def _zero_cache(meta):
    return {k: torch.zeros(m.shape, dtype=m.dtype) for k, m in meta.items()}


def _decode_against_jax(decode, jdecode, p, jp, cfg, jcfg, cache, jcache, x):
    """Step by step over x's positions: each output and the caches at 1e-5."""
    jstep = jax.jit(lambda pp, xx, cc, t: jdecode(pp, jcfg, xx, cc, t))
    outs, jouts = [], []
    for t in range(x.shape[1]):
        o, out_cache = decode(p, cfg, torch.as_tensor(x[:, t : t + 1]), cache, torch.tensor(t))
        assert out_cache is cache
        jo, jcache = jstep(jp, jnp.asarray(x[:, t : t + 1]), jcache, jnp.asarray(t))
        outs.append(_np(o)), jouts.append(np.asarray(jo))
    assert _rel(np.concatenate(outs, 1), np.concatenate(jouts, 1)) < 1e-5
    for k in cache:
        assert _rel(cache[k], jcache[k]) < 1e-5, k
    return np.concatenate(outs, 1)


def test_mamba2_forward_and_decode_match_jax():
    """The smoke block (d_model 64, 8 heads of 16, state 16, chunk 16) over
    40 positions (Q = 10): the forward at 1e-5 of JAX's; 40 decode steps
    at 1e-5 of JAX's, with the in-place caches (state, conv windows)."""
    cfg, jcfg, p, jp = _block(mamba2.mamba2_meta, jmamba2.mamba2_meta, "mamba2-370m", 3)
    x = (np.random.default_rng(4).normal(size=(2, 40, cfg.d_model)) * 0.5).astype(np.float32)
    want = jmamba2.mamba2_forward(jp, jcfg, jnp.asarray(x))
    got = mamba2.mamba2_forward(p, cfg, torch.as_tensor(x))
    assert _rel(got, want) < 1e-5
    meta = mamba2.mamba2_cache_meta(cfg, 2)
    jmeta = jmamba2.mamba2_cache_meta(jcfg, 2)
    assert {k: tuple(m.shape) for k, m in meta.items()} == {k: m.shape for k, m in jmeta.items()}
    assert meta["state"].dtype == torch.float32 and meta["conv"].dtype == cfg.activation_dtype
    jcache = {k: jnp.zeros(m.shape, m.dtype) for k, m in jmeta.items()}
    _decode_against_jax(mamba2.mamba2_decode, jmamba2.mamba2_decode, p, jp, cfg, jcfg, _zero_cache(meta),
                        jcache, x)


def test_rglru_forward_matches_jax_and_stepwise_decode():
    """S = 1056 crosses the 512-position chunk (three chunks of 352, each
    checkpointed): the forward at 1e-5 of JAX's, its gradients (input and
    every weight) at 5e-4 of ``jax.grad``'s, and the port's own decode
    over the same positions at 5e-4."""
    cfg, jcfg, p, jp = _block(griffin.rglru_meta, jgriffin.rglru_meta, "recurrentgemma-2b", 0)
    S = 1056
    x = (np.random.default_rng(5).normal(size=(1, S, cfg.d_model)) * 0.5).astype(np.float32)
    go = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    jy, jvjp = jax.vjp(lambda pp, xx: jgriffin.rglru_forward(pp, jcfg, xx), jp, jnp.asarray(x))
    jgp, jgx = jvjp(jnp.asarray(go))
    paths, leaves_, rebuild = flatten_with_paths(p)
    xs = [t.clone().requires_grad_(True) for t in leaves_] + [torch.tensor(x, requires_grad=True)]
    y = griffin.rglru_forward(rebuild(xs[:-1]), cfg, xs[-1])
    assert _rel(y, jy) < 1e-5
    grads = torch.autograd.grad(y, xs, torch.as_tensor(go))
    for path, g, w in zip(paths + ["x"], grads, jax.tree_util.tree_leaves(jgp) + [jgx]):
        assert _rel(g, w) < 5e-4, path
    cache = _zero_cache(griffin.rglru_cache_meta(cfg, 1))
    with torch.no_grad():
        dec = torch.cat([griffin.rglru_decode(p, cfg, torch.as_tensor(x[:, t : t + 1]), cache, torch.tensor(t))[0]
                         for t in range(S)], dim=1)
    assert _rel(dec, y.detach()) < 5e-4


def test_rglru_decode_matches_jax():
    """24 one-token steps of the smoke block against JAX's, outputs and the
    in-place caches (h float32, the conv window) at 1e-5."""
    cfg, jcfg, p, jp = _block(griffin.rglru_meta, jgriffin.rglru_meta, "recurrentgemma-2b", 7)
    x = (np.random.default_rng(8).normal(size=(2, 24, cfg.d_model)) * 0.5).astype(np.float32)
    meta = griffin.rglru_cache_meta(cfg, 2)
    jmeta = jgriffin.rglru_cache_meta(jcfg, 2)
    assert {k: tuple(m.shape) for k, m in meta.items()} == {k: m.shape for k, m in jmeta.items()}
    jcache = {k: jnp.zeros(m.shape, m.dtype) for k, m in jmeta.items()}
    _decode_against_jax(griffin.rglru_decode, jgriffin.rglru_decode, p, jp, cfg, jcfg, _zero_cache(meta),
                        jcache, x)


@pytest.mark.parametrize("law,lo,hi,inverse", [
    ("lru_a", 0.9, 0.999, torch.sigmoid),
    ("ssm_alog", 1.0, 16.0, torch.exp),
    ("ssm_dtbias", 1e-3, 1e-1, torch.nn.functional.softplus),
])
def test_init_laws_ranges_and_moments(law, lo, hi, inverse):
    """Each law maps U[lo, hi]: its inverse brings the draws back into
    [lo, hi] with the uniform's mean and variance (to sampling error), as
    the JAX package's draws do; deterministic given the generator."""
    m = ParamMeta((64, 512), torch.float32, (None, None), init=law)
    draw = lambda seed: init_params({"w": m}, torch.Generator().manual_seed(seed), device="cpu")["w"]  # noqa: E731
    v = draw(0)
    assert torch.equal(v, draw(0)) and not torch.equal(v, draw(1))
    jv = jparams_mod.init_params({"w": jparams_mod.ParamMeta((64, 512), jnp.float32, (None, None), init=law)},
                                 jax.random.PRNGKey(0))["w"]
    mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
    for u in (inverse(v.double()), inverse(torch.tensor(np.array(jv)).double())):
        tol = 1e-6 * hi
        assert float(u.min()) >= lo - tol and float(u.max()) <= hi + tol
        assert abs(float(u.mean()) - mean) < 0.01 * (hi - lo)
        assert abs(float(u.var()) / var - 1) < 0.03
