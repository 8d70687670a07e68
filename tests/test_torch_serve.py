"""Port parity: the serve path (``repro_torch.models`` caches and
``decode_step``, ``repro_torch.train`` ``make_serve_step`` /
``make_prefill``, ``repro_torch.launch.serve``) against the JAX package's,
CPU.

Each of the ten archs' smoke configs (d_model 64, fp32; 2 layers, or
one (rglru, rglru, attn) unit for recurrentgemma; granite-moe and
mixtral with 4 experts, top-2, the smoke's dense MoE, and mixtral once
more with the full config's dropping MoE; musicgen and llava on tokens,
as the serve path takes them), from one JAX-made set of weights carried
with ``interop.model_params``:
``cache_init``'s tree, shapes and dtypes equal JAX's, then 44
``decode_step``s on the same numpy tokens, the logits of every step at
1e-4 of the largest logit (``TOL``) and the whole cache at the end
(``pos`` exactly, K/V at 1e-4 of their largest entry), then one more
step from JAX's cache carried across with ``interop.model_params``.  Mixtral's smoke
window is 32, so its ring buffer wraps 12 times, as recurrentgemma's local
attention does; mamba2's and the RG-LRU's caches are their recurrent
states and conv windows.  recurrentgemma at 5 layers (one unit and a
remainder of (rglru, rglru), the layout of its 26 published layers) the
same way, and its forward.  Then the greedy tokens of ``make_serve_step``
and ``make_prefill`` equal JAX's, decode equals the full forward at every
position (mixtral and recurrentgemma past their windows, mamba2 over
three SSD chunks, the forward with ``moe_impl="dense"``), a write past
``max_len`` raises, the launcher runs on the CPU, and the device rule (no
card and no ``device="cpu"``: raise).
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
from repro import train as jtrain  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro_torch import configs, interop, models, train  # noqa: E402
from repro_torch.launch.serve import main  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.tree import flatten_with_paths  # noqa: E402

ARCHS = ["llama3.2-3b", "codeqwen1.5-7b", "stablelm-3b", "qwen3-14b", "granite-moe-3b-a800m",
         "mixtral-8x7b", "mamba2-370m", "recurrentgemma-2b", "musicgen-large", "llava-next-mistral-7b"]
CASES = [(a, None) for a in ARCHS] + [("mixtral-8x7b", "dropping")]
B, STEPS, MAX_LEN = 2, 44, 48
# Float32 over 2 layers: on these weights and tokens each package's decode
# logits sit up to 2.5e-5 of the largest logit from a float64 run of the
# port, so the two packages differ by up to ~5e-5 (mixtral, codeqwen).
TOL = 1e-4


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _pair(arch, moe_impl=None, seed=0, **over):
    """The smoke config on both sides and JAX-made weights carried across."""
    if moe_impl is not None:
        over["moe_impl"] = moe_impl
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **over)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **over)
    jparams = jmodels.model_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, interop.model_params(jax.tree_util.tree_map(np.asarray, jparams))


def _tokens(cfg, n, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(n, B, 1)).astype(np.int32)


def _window(cfg):
    """The attention layers' window (recurrentgemma: the local one), or None."""
    return cfg.local_window if cfg.family == "hybrid" else cfg.sliding_window


@pytest.mark.parametrize("arch,moe_impl", CASES)
def test_decode_steps_match_jax(arch, moe_impl):
    _decode_steps_match_jax(*_pair(arch, moe_impl))


def test_hybrid_remainder_layout_matches_jax():
    """recurrentgemma-2b at 5 layers: one (rglru, rglru, attn) unit and a
    remainder (rglru, rglru) under ``rem``, as its 26 layers are 8 units and
    that remainder.  The forward at 1e-5 of JAX's, then the decode steps
    and caches as in ``test_decode_steps_match_jax``."""
    jcfg, cfg, jparams, params = _pair("recurrentgemma-2b", n_layers=5)
    assert models.pattern_unit(cfg) == (("rglru", "rglru", "attn"), 1, ("rglru", "rglru"))
    assert sorted(params["rem"]) == ["R0_rglru", "R1_rglru"]
    toks = _tokens(cfg, 40, seed=6)[:, :, 0].T
    ref_cfg, jref_cfg = (dataclasses.replace(c, attn_chunk=8, attn_kv_chunk=8) for c in (cfg, jcfg))
    jlogits, _ = jmodels.forward(jparams, jref_cfg, tokens=jnp.asarray(toks))
    logits, _ = models.forward(params, ref_cfg, tokens=torch.as_tensor(toks))
    assert _rel(logits, jlogits) < 1e-5
    _decode_steps_match_jax(jcfg, cfg, jparams, params)


def _decode_steps_match_jax(jcfg, cfg, jparams, params):
    jcache = jmodels.cache_init(jcfg, B, MAX_LEN)
    cache = models.cache_init(cfg, B, MAX_LEN, device="cpu")
    meta = models.cache_meta(cfg, B, MAX_LEN)
    paths, got, _ = flatten_with_paths(cache)
    jflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert paths == ["/".join(str(k) for k in p) for p, _ in jflat]
    for c, m, (_, j) in zip(got, flatten_with_paths(meta)[1], jflat):
        assert tuple(c.shape) == tuple(m.shape) == j.shape and m.device.type == "meta"
        assert c.dtype == m.dtype and str(c.dtype).split(".")[1] == str(j.dtype)
    pat = models.pattern_unit(cfg)[0]
    if "attn" in pat:
        W = cache["units"][f"L{pat.index('attn')}_attn"]["k"].shape[2]
        assert W == (32 if _window(cfg) else MAX_LEN)
        layer = attention.attn_cache_init(cfg, B, MAX_LEN, _window(cfg), device="cpu")
        jlayer = jattention.attn_cache_init(jcfg, B, MAX_LEN, _window(jcfg))
        assert {k: tuple(v.shape) for k, v in layer.items()} == {k: v.shape for k, v in jlayer.items()}

    jstep = jax.jit(lambda p, c, t: jmodels.decode_step(p, jcfg, c, tokens=t))
    got, want = [], []
    for tok in _tokens(cfg, STEPS):
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok))
        logits, out = models.decode_step(params, cfg, cache, tokens=torch.as_tensor(tok))
        assert out is cache and logits.dtype == torch.float32
        got.append(_np(logits)), want.append(np.asarray(jlogits))
    assert _rel(np.stack(got), np.stack(want)) < TOL
    assert int(cache["pos"]) == int(jcache["pos"]) == STEPS and cache["pos"].dtype == torch.int32
    paths, got, _ = flatten_with_paths(cache)
    for path, c, j in zip(paths, got, jax.tree_util.tree_leaves(jcache)):
        assert _rel(c, j) < TOL, path
    # JAX's cache carried across: the port's next step from it is JAX's.
    carried = interop.model_params(jax.tree_util.tree_map(np.asarray, jcache))
    tok = _tokens(cfg, 1, seed=9)[0]
    jlogits, _ = jstep(jparams, jcache, jnp.asarray(tok))
    logits, _ = models.decode_step(params, cfg, carried, tokens=torch.as_tensor(tok))
    assert _rel(logits, jlogits) < TOL and int(carried["pos"]) == STEPS + 1


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mixtral-8x7b"])
def test_serve_step_and_prefill_match_jax(arch):
    """12 teacher-forced steps, then 8 greedy ones, through each package's
    serve step: the same 20 tokens out; ``make_prefill`` on the prompt
    gives JAX's token, and the serve step's after the prompt."""
    jcfg, cfg, jparams, params = _pair(arch, seed=2)
    prompt = _tokens(cfg, 12, seed=3)
    jserve = jax.jit(jtrain.make_serve_step(jcfg))
    serve = train.make_serve_step(cfg, device="cpu")
    jcache = jmodels.cache_init(jcfg, B, 20)
    cache = models.cache_init(cfg, B, 20, device="cpu")
    jout, out = [], []
    for tok in prompt:
        jn, jcache = jserve(jparams, jcache, jnp.asarray(tok))
        n, cache = serve(params, cache, torch.as_tensor(tok))
        jout.append(np.asarray(jn)), out.append(n)
    for _ in range(8):
        jn, jcache = jserve(jparams, jcache, jn[:, None])
        n, cache = serve(params, cache, n[:, None])
        jout.append(np.asarray(jn)), out.append(n)
    assert out[0].dtype == torch.int32
    np.testing.assert_array_equal(torch.stack(out).numpy(), np.stack(jout))
    batch = {"tokens": prompt[:, :, 0].T}
    first = train.make_prefill(cfg, device="cpu")(params, {"tokens": torch.as_tensor(batch["tokens"])})
    np.testing.assert_array_equal(first.numpy(), np.asarray(jtrain.make_prefill(jcfg)(jparams, batch)))
    np.testing.assert_array_equal(first.numpy(), out[len(prompt) - 1].numpy())


@pytest.mark.parametrize("arch,moe_impl", [("llama3.2-3b", None), ("mixtral-8x7b", "dropping"),
                                          ("mamba2-370m", None), ("recurrentgemma-2b", None)])
def test_decode_equals_forward_at_every_position(arch, moe_impl):
    """The port alone: decode's logits at each of 48 positions against
    ``forward`` over the same tokens at ``TOL`` (mixtral's window and
    recurrentgemma's local window are 32, so 16 positions read a wrapped
    ring; mixtral's forward runs the dense MoE, which drops no token, on
    the same weights; mamba2's forward runs three SSD chunks of 16 where
    decode steps the recurrence).  ``LM.decode_step`` is the function on
    the module's weights."""
    _, cfg, _, params = _pair(arch, moe_impl, seed=4)
    S = 48
    toks = _tokens(cfg, S, seed=5)
    cache = models.cache_init(cfg, B, S, device="cpu")
    lm = models.LM(cfg, params)
    with torch.inference_mode():
        dec = [lm.decode_step(cache, tokens=torch.as_tensor(t))[0] for t in toks]
        ref_cfg = dataclasses.replace(cfg, moe_impl="dense", attn_chunk=16, attn_kv_chunk=16)
        ref, _ = models.forward(params, ref_cfg, tokens=torch.as_tensor(toks[:, :, 0].T))
    dec = torch.cat(dec, dim=1)
    assert _rel(dec, ref) < TOL
    if _window(cfg):
        assert _rel(dec[:, 32:], ref[:, 32:]) < TOL


def test_cache_write_past_max_len_raises():
    """JAX's ``dynamic_update_slice`` clamps a write past ``max_len`` onto
    the last slot; the port's full-attention layers raise.  A ring buffer
    takes any number of positions."""
    _, cfg, _, params = _pair("llama3.2-3b")
    cache = models.cache_init(cfg, B, 4, device="cpu")
    toks = torch.as_tensor(_tokens(cfg, 5))
    for t in toks[:4]:
        models.decode_step(params, cfg, cache, tokens=t)
    with pytest.raises((IndexError, RuntimeError), match="out of (bounds|range)"):
        models.decode_step(params, cfg, cache, tokens=toks[4])
    _, cfg, _, params = _pair("mixtral-8x7b")
    cache = models.cache_init(cfg, B, 4, device="cpu")
    for t in toks:
        models.decode_step(params, cfg, cache, tokens=t)
    assert int(cache["pos"]) == 5


def test_launcher_on_cpu(capsys):
    """The serve launcher with a prompt longer than mixtral's smoke window
    (the ring wraps), printing the JAX launcher's three lines."""
    out = main(["--arch", "mixtral-8x7b", "--smoke", "--batch", "2", "--prompt-len", "36", "--gen", "4",
                "--device", "cpu"])
    assert tuple(out.shape) == (2, 4) and out.dtype == torch.int32
    assert int(out.min()) >= 0 and int(out.max()) < configs.get_smoke_config("mixtral-8x7b").vocab
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "[serve] mixtral-8x7b: batch=2 prompt=36 gen=4"
    assert lines[1].startswith("[serve] prefill ") and "ms/token/batch" in lines[1]
    assert lines[2].startswith("[serve] sample generations: [[")


def test_entry_points_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = configs.get_smoke_config("mixtral-8x7b")
    for fn in (lambda: models.cache_init(cfg, B, 8), lambda: train.make_serve_step(cfg),
               lambda: train.make_prefill(cfg), lambda: main(["--arch", "mixtral-8x7b", "--smoke"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
