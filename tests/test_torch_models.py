"""Port parity: ``repro_torch.models`` / ``repro_torch.configs`` against
``repro.models`` / ``repro.configs``, CPU.

The llama3.2-3b smoke config (2 stacked layers, d_model 64, GQA 2/2,
vocab 512, fp32, ``remat="block"``) from one JAX-made set of weights,
carried with ``interop.model_params``: logits, the chunked cross-entropy
loss and every leaf's gradient against ``jax.value_and_grad`` on the same
numpy batch, at 1e-5 (logits, loss) and 5e-4 (gradients) of the largest
entry.  Flash attention (causal and windowed, GQA, several query and key
chunks) and its backward, the norms and rotary at 1e-5.  Initialisation
uses torch's generator, so it is held to the JAX package's shapes, init
laws and fan-in rule in distribution.  Plus the configs, the ``LM``
module, and the device rule (no card and no ``device="cpu"``: raise).
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
from repro.models import flash as jflash  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.train import make_loss_fn as jax_make_loss_fn  # noqa: E402
from repro_torch import configs, interop, models  # noqa: E402
from repro_torch.models import flash, layers  # noqa: E402
from repro_torch.train import make_loss_fn  # noqa: E402
from repro_torch.train.step import value_and_grad  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

ARCH = "llama3.2-3b"
B, S = 2, 64


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.fixture(scope="module")
def smoke():
    """The smoke config on both sides, JAX-made weights carried to the port,
    and one numpy batch."""
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    jparams = jmodels.model_params(jcfg, jax.random.PRNGKey(0))
    params = interop.model_params(jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
    return jcfg, cfg, jparams, params, {"tokens": tokens, "labels": labels}


def test_smoke_config_equals_jax():
    jcfg = jconfigs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    full = configs.get_config(ARCH)
    assert dataclasses.asdict(full) == dataclasses.asdict(jconfigs.get_config(ARCH))
    assert full.activation_dtype == torch.bfloat16 and full.parameter_dtype == torch.float32
    assert cfg.activation_dtype == torch.float32 and full.layer_kinds == ("attn",) * 28
    assert full.param_counts() == jconfigs.get_config(ARCH).param_counts()


def test_configs_names_and_unported_archs():
    assert configs.ARCHS == jconfigs.ARCHS
    for name in ("llama3.2-3b", "llama32-3b", "llama32_3b"):
        assert configs.canonical(name) == jconfigs.canonical(name) == "llama32_3b"
    with pytest.raises(KeyError):
        configs.canonical("gpt-5")
    for arch in configs.ARCHS:
        if arch != "llama32_3b":
            with pytest.raises(NotImplementedError, match="item 13"):
                configs.get_config(arch)


def test_meta_shapes_and_counts_equal_jax():
    for cfg_fn in (configs.get_config, configs.get_smoke_config):
        jcfg_fn = getattr(jconfigs, cfg_fn.__name__)
        meta, jmeta = models.model_meta(cfg_fn(ARCH)), jmodels.model_meta(jcfg_fn(ARCH))
        paths, metas, _ = flatten_with_paths(meta)
        jflat = jax.tree_util.tree_flatten_with_path(jmeta, is_leaf=lambda x: hasattr(x, "axes"))[0]
        assert paths == ["/".join(str(k) for k in p) for p, _ in jflat]
        for m, (_, jm) in zip(metas, jflat):
            assert (m.shape, m.axes, m.init, m.scale, m.fan_in_axis) == (
                jm.shape, jm.axes, jm.init, jm.scale, jm.fan_in_axis)
        assert models.param_count(meta) == jmodels.param_count(jmeta)
    full = models.abstract_params(models.model_meta(configs.get_config(ARCH)))
    assert tuple(full["units"]["L0_attn"]["attn"]["wq"].shape) == (28, 3072, 24, 128)
    assert full["embed"].device.type == "meta"


def test_init_params_statistics():
    """Torch's stream, the JAX package's laws: ones for norm scales, normal
    with std scale / sqrt(fan_in), where fan-in is dim 0 of the leaf unless
    its meta names an axis (so a stacked leaf's is its layer count, as in
    the JAX package); deterministic given the generator."""
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), d_model=128, d_ff=256)
    meta = models.model_meta(cfg)
    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    p1 = models.init_params(meta, gen(0), device="cpu")
    p2 = models.init_params(meta, gen(0), device="cpu")
    p3 = models.init_params(meta, gen(1), device="cpu")
    paths, l1, _ = flatten_with_paths(p1)
    _, metas, _ = flatten_with_paths(meta)
    for path, a, b, c, m in zip(paths, l1, flatten_with_paths(p2)[1], flatten_with_paths(p3)[1], metas):
        assert tuple(a.shape) == m.shape and a.dtype == m.dtype
        assert torch.equal(a, b)
        if m.init == "ones":
            assert bool((a == 1).all())
            continue
        assert not torch.equal(a, c)
        fan_in = m.shape[m.fan_in_axis] if m.fan_in_axis is not None else m.shape[0]
        std = m.scale / fan_in ** 0.5
        assert abs(float(a.std()) / std - 1) < 0.05, (path, float(a.std()), std)
        assert abs(float(a.mean())) < 0.05 * std
    jp = jmodels.model_params(jconfigs.get_smoke_config(ARCH), jax.random.PRNGKey(0))
    pp = models.model_params(configs.get_smoke_config(ARCH), torch.Generator().manual_seed(0), device="cpu")
    for (path, a), b in zip(zip(*flatten_with_paths(pp)[:2]), jax.tree_util.tree_leaves(jp)):
        b = np.asarray(b)
        assert a.shape == b.shape
        if b.std() > 0:  # the same law: stds agree to sampling error
            assert abs(float(a.std()) / float(b.std()) - 1) < 0.1, path


def test_forward_logits_and_loss_match_jax(smoke):
    jcfg, cfg, jparams, params, batch = smoke
    jlogits, _ = jmodels.forward(jparams, jcfg, tokens=jnp.asarray(batch["tokens"]))
    logits, aux = models.forward(params, cfg, tokens=torch.as_tensor(batch["tokens"]))
    assert logits.dtype == torch.float32 and float(aux["moe_lb"]) == 0.0
    assert _rel(logits, jlogits) < 1e-5
    lm = models.LM(cfg, params)
    assert torch.equal(lm(torch.as_tensor(batch["tokens"]))[0], logits)
    names = dict(lm.named_parameters())
    assert tuple(names["weights.units.L0_attn.attn.wq"].shape) == (2, 64, 2, 16)
    assert len(names) == len(flatten_with_paths(params)[1])


def test_loss_and_grads_match_jax(smoke):
    """``jax.value_and_grad`` of the training loss (chunked CE over the
    tied embedding, remat per block) against the port's, every leaf at
    5e-4 of its largest entry (float32 gradients summed over the batch's
    tokens in other orders)."""
    jcfg, cfg, jparams, params, batch = smoke
    (jl, _), jg = jax.value_and_grad(jax_make_loss_fn(jcfg), has_aux=True)(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    (pl, metrics), pg = value_and_grad(make_loss_fn(cfg), params,
                                       {k: torch.as_tensor(v) for k, v in batch.items()})
    assert abs(float(pl) - float(jl)) < 1e-5 * abs(float(jl))
    assert float(metrics["ce"]) == float(pl)
    paths, gl, _ = flatten_with_paths(pg)
    for path, g, w in zip(paths, gl, jax.tree_util.tree_leaves(jg)):
        assert _rel(g, w) < 5e-4, path


@pytest.mark.parametrize("window,softcap,cq,ck", [(None, None, 16, 16), (24, None, 32, 16),
                                                  (None, 30.0, 64, 32)])
def test_flash_attention_matches_jax(window, softcap, cq, ck):
    """Forward (out in q's dtype) and the recomputing backward (dq, dk, dv;
    the backward ignores softcap, as the JAX package's does)."""
    rng = np.random.default_rng(1)
    hkv, G, hd = 2, 3, 8
    q = rng.normal(size=(B, S // cq, cq, hkv, G, hd)).astype(np.float32) * hd ** -0.5
    k = rng.normal(size=(B, S, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, hkv, hd)).astype(np.float32)
    go = rng.normal(size=q.shape).astype(np.float32)
    jout, vjp = jax.vjp(lambda a, b, c: jflash.flash_attention(a, b, c, ck, window, softcap),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(go))
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = flash.flash_attention(*xs, ck, window, softcap)
    grads = torch.autograd.grad(out, xs, torch.as_tensor(go))
    assert _rel(out, jout) < 1e-5
    for g, w in zip(grads, jgrads):
        assert _rel(g, w) < 1e-5


def test_flash_attention_equals_plain_softmax():
    """Against softmax(q k^T + causal mask) v computed whole."""
    rng = np.random.default_rng(2)
    q = torch.tensor(rng.normal(size=(1, 4, 8, 1, 2, 4)).astype(np.float32))
    k = torch.tensor(rng.normal(size=(1, 32, 1, 4)).astype(np.float32))
    v = torch.tensor(rng.normal(size=(1, 32, 1, 4)).astype(np.float32))
    out = flash.flash_attention(q, k, v, 8, None, None).reshape(32, 2, 4)
    s = torch.einsum("qgk,ck->gqc", q.reshape(32, 2, 4), k[0, :, 0])
    s = s.masked_fill(torch.ones(32, 32, dtype=torch.bool).triu(1), float("-inf"))
    want = torch.einsum("gqc,ck->qgk", torch.softmax(s, -1), v[0, :, 0])
    assert float((out - want).abs().max()) < 1e-5


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_and_rotary_match_jax(kind):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    p = {"scale": rng.normal(size=(16,)).astype(np.float32), "bias": rng.normal(size=(16,)).astype(np.float32)}
    got = layers.apply_norm({k: torch.as_tensor(v) for k, v in p.items()}, torch.as_tensor(x), kind)
    assert _rel(got, jlayers.apply_norm(p, jnp.asarray(x), kind)) < 1e-5
    pos = np.arange(5)
    jc, js = jlayers.rotary_cos_sin(jnp.asarray(pos), 16, 500_000.0)
    c, s = layers.rotary_cos_sin(torch.as_tensor(pos), 16, 500_000.0)
    assert _rel(c, jc) < 1e-6 and _rel(s, js) < 1e-6
    assert _rel(layers.apply_rotary(torch.as_tensor(x), c, s), jlayers.apply_rotary(jnp.asarray(x), jc, js)) < 1e-5


def test_entry_points_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = configs.get_smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.model_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        models.init_params(models.model_meta(cfg), torch.Generator())
    with pytest.raises(NotImplementedError, match="item 12"):
        models.partition_specs(models.model_meta(cfg), {})


def _gqa_logits(dtype):
    """Logits of the smoke model with 4 query heads on 2 KV heads (as
    llama3.2-3b groups 24 on 8) in activation dtype ``dtype`` (weights fp32),
    JAX's and the port's from the same weights and tokens."""
    over = dict(n_heads=4, n_kv_heads=2, dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), **over)
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH), **over)
    jparams = jmodels.model_params(jcfg, jax.random.PRNGKey(1))
    params = interop.model_params(jax.tree_util.tree_map(np.asarray, jparams))
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    jlogits, _ = jmodels.forward(jparams, jcfg, tokens=jnp.asarray(tokens))
    logits, _ = models.forward(params, cfg, tokens=torch.as_tensor(tokens))
    assert logits.dtype == torch.float32
    return _np(logits).astype(np.float64), np.asarray(jlogits, np.float64)


def test_forward_gqa_and_bf16_match_jax():
    """Grouped heads at 1e-4 in fp32.  In bf16 (the full config's
    activations) both packages sit ~1e-2 (mean) from the fp32 logits, each
    rounding its own way: the port's logits within 1.25x the JAX package's
    distance from fp32 (max and mean), and within 5e-3 (mean) of JAX's."""
    got, want = _gqa_logits("float32")
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-4
    got16, want16 = _gqa_logits("bfloat16")
    for red in (np.max, np.mean):
        assert red(np.abs(got16 - want)) <= 1.25 * red(np.abs(want16 - want))
    assert np.abs(got16 - want16).mean() / scale < 5e-3
