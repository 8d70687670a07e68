"""Port parity and behaviour: ``repro_torch.train``, ``.data``, ``.ckpt`` and
``.launch.train``, CPU.

One ``make_train_step`` on the llama3.2-3b smoke config from one JAX-made
state (weights carried with ``interop``, the same numpy batch) against the
JAX package's: with AdamW, with AdamW over 2 microbatches, and with
Shampoo, and with Shampoo on the mamba2-370m smoke config (its SSD
chunks, conv and per-head leaves through the preconditioner); loss, grad
norm and new weights at 1e-4, the momentum at 1e-3 of its largest entry
(the Shampoo step's statistics at 1e-6 relative).
Microbatches = 2 against 1 on the port at 1e-5; the error-feedback
compressed step against its pieces.  Then the
port's own behaviour: the training loop's loss drops through the launcher
(``--device cpu``, as tests/test_system.py drives the JAX one), the
launcher runs Shampoo, checkpoints save, restore and resume a run to the
same weights, a NaN step rolls back, the synthetic stream's shapes and
statistics, and the device rule (no card and no ``device="cpu"``: raise).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro import train as jtrain  # noqa: E402
from repro.solver import EvdConfig as JaxConfig  # noqa: E402
from repro_torch import configs, data, interop, optim, train  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.launch.train import main  # noqa: E402
from repro_torch.solver import EvdConfig  # noqa: E402
from repro_torch.tree import flatten_with_paths, leaves  # noqa: E402

ARCH = "llama3.2-3b"
B, S = 4, 32


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol, label=""):
    paths, gl, _ = flatten_with_paths(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for path, g, w in zip(paths, gl, wl):
        g, w = _np(g).astype(np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape, (label, path)
        err = float(np.abs(g - w).max()) / max(float(np.abs(w).max()), 1e-30)
        assert err < tol, (label, path, err)


@pytest.fixture(scope="module")
def start():
    return _start(ARCH)


def _start(arch):
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    jparams = jmodels.model_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": np.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)}
    return jcfg, cfg, jparams, batch


def _both(jparams, batch):
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    pb = {k: torch.as_tensor(v) for k, v in batch.items()}
    return jb, pb, interop.model_params(jax.tree_util.tree_map(np.asarray, jparams))


def _start_state(case, jo, jparams):
    """A JAX-made optimizer state: AdamW's second moment (Shampoo's
    diagonal one) set to 1, so the step's update is the learning rate times
    a linear function of the gradient and the comparison sees how well the
    two packages' gradients agree, not Adam's per-coordinate normalization
    of near-zero ones (tests/test_torch_optim.py holds that arithmetic on
    its own).  Shampoo's statistics are 1.5 I, so the step's keep
    max|w| > 1, where the JAX package's inverse iteration is right (below
    it, it floors its shift offset at 1; ROADMAP Queue 3)."""
    st = jo.init(jparams)
    st = st._replace(nu=jax.tree_util.tree_map(jnp.ones_like, st.nu))
    if case.startswith("shampoo"):
        eye = 1.5 * jnp.broadcast_to(jnp.eye(st.stats_l.shape[-1]), st.stats_l.shape)
        st = st._replace(stats_l=eye, stats_r=eye)
    return st


CASES = {"adamw": 1, "adamw-microbatches-2": 2, "shampoo": 1, "shampoo-mamba2": 1}
CASE_ARCH = {"shampoo-mamba2": "mamba2-370m"}


def _optimizers(case):
    if case.startswith("shampoo"):
        sh = dict(block_size=64, update_interval=10)
        return (jopt.shampoo(1e-2, opts=jopt.ShampooOptions(**sh, evd=JaxConfig(b=4, nb=16, backend="jnp"))),
                optim.shampoo(1e-2, opts=optim.ShampooOptions(**sh, evd=EvdConfig(b=4, nb=16))))
    return jopt.adamw(1e-2), optim.adamw(1e-2)


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(start, case):
    """One step on each side from the same weights, optimizer state
    (``_start_state``) and batch: loss and grad norm at 1e-4 relative, the
    new weights at 1e-4 of each leaf's largest entry, the momentum (the
    step's update direction, before the learning rate) at 1e-3 (float32
    gradients summed over the batch's tokens: the JAX package's own float32
    gradients are a few 1e-4 of the largest entry from its float64 ones on
    such a batch), Shampoo's statistics at 1e-6."""
    jcfg, cfg, jparams, batch = _start(CASE_ARCH[case]) if case in CASE_ARCH else start
    jo, po = _optimizers(case)
    jstate = _start_state(case, jo, jparams)
    host = jax.tree_util.tree_map(np.asarray, jstate)
    shampoo = case.startswith("shampoo")
    pstate = interop.shampoo_state(host) if shampoo else interop.adamw_state(host)
    jb, pb, pparams = _both(jparams, batch)
    jstep = jtrain.make_train_step(jcfg, jo, microbatches=CASES[case])
    pstep = train.make_train_step(cfg, po, microbatches=CASES[case])
    jp2, js2, jm = jstep(jparams, jstate, jb, jnp.zeros((), jnp.int32))
    pp2, ps2, pm = pstep(pparams, pstate, pb, 0)
    for key in ("loss", "grad_norm"):
        assert abs(float(pm[key]) - float(jm[key])) < 1e-4 * abs(float(jm[key])), key
    _close(pp2, jp2, 1e-4, f"{case} weights")
    _close(ps2.mu, js2.mu, 1e-3, f"{case} momentum")
    if shampoo:
        _close(ps2.stats_l, js2.stats_l, 1e-6, "stats_l")
        _close(ps2.stats_r, js2.stats_r, 1e-6, "stats_r")


def test_microbatches_two_equal_one(start):
    """Equal microbatches: the mean of their mean losses is the batch's
    mean loss and the mean of their gradients the batch's gradient: loss
    at 1e-5, the SGD-like update of a fixed AdamW state at 1e-5."""
    _, cfg, jparams, batch = start
    _, pb, pparams = _both(jparams, batch)
    opt = optim.adamw(1e-2)
    state = opt.init(pparams)
    state = state._replace(nu=jax.tree_util.tree_map(lambda v: v + 1.0, state.nu))  # |update| ~ lr |g|
    out = {micro: train.make_train_step(cfg, opt, microbatches=micro)(pparams, state, pb, 0) for micro in (1, 2)}
    assert abs(float(out[2][2]["loss"]) - float(out[1][2]["loss"])) < 1e-5 * float(out[1][2]["loss"])
    _close(out[2][0], interop.to_numpy(out[1][0]), 1e-5, "microbatches")


def test_train_step_with_ef_compression(start):
    """``compression=ef_compress_transform()``: the state is (optimizer
    state, EF state); the step equals compressing the plain gradients with
    the transform and updating with them (the transform itself is held
    against the JAX package's in tests/test_torch_optim.py)."""
    _, cfg, jparams, batch = start
    _, pb, params = _both(jparams, batch)
    opt, ef = optim.adamw(1e-2), optim.ef_compress_transform()
    step = train.make_train_step(cfg, opt, compression=ef)
    state = (opt.init(params), ef[0](params))
    p2, (s2, e2), m = step(params, state, pb, 0)
    (_, _), grads = train.step.value_and_grad(train.make_loss_fn(cfg), params, pb)
    gq, e_want = ef[1](grads, ef[0](params))
    upd, s_want = opt.update(gq, opt.init(params), params)
    for a, b in zip(leaves((p2, s2, e2)), leaves((optim.apply_updates(params, upd), s_want, e_want))):
        assert torch.equal(a, b)
    assert float(m["grad_norm"]) == float(optim.global_norm(upd))


def test_training_loss_drops():
    hist = main(["--arch", ARCH, "--smoke", "--steps", "150", "--batch", "16", "--seq", "64",
                 "--lr", "1e-2", "--log-every", "100", "--device", "cpu"])
    assert min(hist[-10:]) < hist[0] - 0.25, (hist[0], hist[-1])


def test_launcher_runs_shampoo_on_cpu(monkeypatch):
    import importlib

    sh = importlib.import_module("repro_torch.optim.shampoo")
    calls = []
    orig = sh.solve_many
    monkeypatch.setattr(sh, "solve_many", lambda *a, **k: calls.append(k["op"]) or orig(*a, **k))
    hist = main(["--arch", ARCH, "--smoke", "--steps", "3", "--batch", "4", "--seq", "32",
                 "--optimizer", "shampoo", "--lr", "5e-3", "--device", "cpu"])
    assert len(hist) == 3 and all(np.isfinite(hist))
    assert calls == ["inverse_pth_root"] * 2  # step 1 only (update_interval 10)


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-mistral-7b"])
def test_frontend_archs_train_on_embeds(arch):
    """The audio and vision backbones train on the synthetic stream's
    precomputed embeddings (bf16, ``frontend_dim`` wide): two AdamW steps
    through ``make_train_step`` move ``frontend_proj`` and give finite
    losses, and the launcher does the same from its flags."""
    cfg = configs.get_smoke_config(arch)
    dc = data.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=1, frontend_dim=cfg.frontend_dim)
    params = interop.model_params(jax.tree_util.tree_map(
        np.asarray, jmodels.model_params(jconfigs.get_smoke_config(arch), jax.random.PRNGKey(3))))
    opt = optim.adamw(1e-3)
    step, state, p = train.make_train_step(cfg, opt), opt.init(params), params
    for i in range(2):
        batch = data.synthetic_batch(dc, i, device="cpu")
        assert tuple(batch["embeds"].shape) == (2, 16, cfg.frontend_dim)
        p, state, m = step(p, state, batch, i)
        assert np.isfinite(float(m["loss"]))
    assert not torch.equal(p["frontend_proj"], params["frontend_proj"])
    hist = main(["--arch", arch, "--smoke", "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert len(hist) == 2 and all(np.isfinite(hist))


SHARDED_ARGV = ["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "4", "--seq", "32", "--device", "cpu"]


@pytest.fixture(scope="module")
def sharded_launcher(tmp_path_factory):
    """``main(SHARDED_ARGV + ["--model-axis", "2"])`` on two gloo CPU ranks
    (a (1, 2) mesh: heads, vocabulary and MLP split on the model axis),
    with a checkpoint directory; then its checkpoint restored with
    ``shardings=`` in the same world."""
    import torch_shard_ranks as ranks
    from repro_torch.models import model_params
    from repro_torch.parallel import run_ranks

    ckpt = str(tmp_path_factory.mktemp("sharded_launcher") / "ckpt")
    whole = model_params(configs.get_smoke_config(ARCH), torch.Generator().manual_seed(0), device="cpu")
    argv = SHARDED_ARGV + ["--model-axis", "2", "--ckpt-dir", ckpt]
    res = run_ranks(ranks.launcher_ranks, 2, backend="gloo", device_type="cpu", args=(argv, ckpt, whole),
                    timeout_s=300)
    return dict(res=res, ckpt=ckpt, whole=whole)


def test_launcher_model_axis_2_equals_model_axis_1(sharded_launcher):
    """The launcher on two ranks with ``--model-axis 2`` gives the 2-step
    loss history of one process (``--model-axis 1``) at 1e-5, on every
    rank."""
    one = main(SHARDED_ARGV + ["--model-axis", "1"])
    for res in sharded_launcher["res"]:
        assert len(res["history"]) == 2
        np.testing.assert_allclose(res["history"], one, rtol=1e-5)


def _loop_parts(cfg):
    dc = data.DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2, seed=3)
    opt = optim.adamw(1e-3)
    return train.make_train_step(cfg, opt), (lambda s: data.synthetic_batch(dc, s, device="cpu")), opt


def test_checkpoint_roundtrip_and_resume(tmp_path, sharded_launcher):
    """Save/restore keeps every leaf of params and a Shampoo state (bf16
    through float32) in the target's device and dtype; a run stopped at
    step 4 and resumed to 6 reaches the weights and AdamW state of an
    uninterrupted 6-step run, bit for bit."""
    small = {"x": torch.randn(16, 8), "n": torch.randn(8)}
    tree = {"w": torch.randn(3, 4), "h": torch.randn(5).to(torch.bfloat16),
            "s": optim.shampoo(opts=optim.ShampooOptions(block_size=8)).init(small)}
    mgr = CheckpointManager(str(tmp_path / "rt"), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, tree)
    mgr.wait()
    assert mgr.all_steps() == [2, 3]
    back = mgr.restore(3, tree)
    for a, b in zip(leaves(back), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # A sharded run's checkpoint, restored with shardings= into a 2-rank
    # world (tests/torch_shard_ranks.py): each rank's blocks, gathered,
    # equal the whole saved values.
    whole = CheckpointManager(sharded_launcher["ckpt"]).restore(
        sharded_launcher["res"][0]["step"], {"params": sharded_launcher["whole"]})["params"]
    embed = [i for i, t in enumerate(leaves(whole)) if t is whole["embed"]][0]
    for res in sharded_launcher["res"]:
        assert res["local_shapes"][embed] == (256, 64)  # the vocabulary on 2 ranks
        for a, b in zip(res["whole"], leaves(whole)):
            np.testing.assert_array_equal(a, b.numpy())

    cfg = configs.get_smoke_config(ARCH)
    params = interop.model_params(jax.tree_util.tree_map(
        np.asarray, jmodels.model_params(jconfigs.get_smoke_config(ARCH), jax.random.PRNGKey(1))))
    step_fn, batch_fn, opt = _loop_parts(cfg)
    ref, ref_state, _ = train.TrainLoop(step_fn, batch_fn, train.TrainLoopConfig(total_steps=6),
                                        log_fn=lambda m: None).run(params, opt.init(params))
    d = str(tmp_path / "run")
    logs = []
    train.TrainLoop(step_fn, batch_fn, train.TrainLoopConfig(total_steps=4, ckpt_every=2, ckpt_dir=d),
                    log_fn=logs.append).run(params, opt.init(params))
    loop = train.TrainLoop(step_fn, batch_fn, train.TrainLoopConfig(total_steps=6, ckpt_every=2, ckpt_dir=d),
                           log_fn=logs.append)
    got, got_state, hist = loop.run(params, opt.init(params))
    assert "[loop] resumed from checkpoint step 4" in logs and len(hist) == 2
    for a, b in zip(leaves((got, got_state)), leaves((ref, ref_state))):
        assert torch.equal(a, b)


def test_nan_step_rolls_back(tmp_path):
    cfg = configs.get_smoke_config(ARCH)
    params = interop.model_params(jax.tree_util.tree_map(
        np.asarray, jmodels.model_params(jconfigs.get_smoke_config(ARCH), jax.random.PRNGKey(2))))
    step_fn, batch_fn, opt = _loop_parts(cfg)

    def poisoned(p, s, batch, step):
        p2, s2, m = step_fn(p, s, batch, step)
        if step == 3:
            m["loss"] = torch.tensor(float("nan"))
        return p2, s2, m

    logs = []
    loop = train.TrainLoop(poisoned, batch_fn,
                           train.TrainLoopConfig(total_steps=5, ckpt_every=2, ckpt_dir=str(tmp_path)),
                           log_fn=logs.append)
    _, _, hist = loop.run(params, opt.init(params))
    assert len(hist) == 4 and all(np.isfinite(hist))
    assert any("rolled back to step 2, skipping data step 3" in m for m in logs)
    with pytest.raises(FloatingPointError):
        train.TrainLoop(poisoned, batch_fn, train.TrainLoopConfig(total_steps=5), log_fn=logs.append).run(
            params, opt.init(params))


def _kinds(tokens, V):
    """Per row: 0 = runs of 8, 1 = arithmetic progression mod V, 2 = other."""
    t = tokens.astype(np.int64)
    runs = (t.reshape(t.shape[0], -1, 8) == t.reshape(t.shape[0], -1, 8)[:, :, :1]).all((1, 2))
    dif = np.diff(t, axis=1) % V
    arith = (dif == dif[:, :1]).all(1) & (dif[:, 0] >= 1) & (dif[:, 0] <= 6)
    return np.where(runs, 0, np.where(arith, 1, 2))


def test_synthetic_batch_shapes_and_statistics():
    """The JAX package's three streams in the same proportions (a third
    each, to sampling error), the noise stream's mean token V/3, labels the
    next tokens, deterministic per (seed, step)."""
    V = 1000
    dc = data.DataConfig(vocab=V, seq_len=64, global_batch=600, seed=7)
    b = data.synthetic_batch(dc, 5, device="cpu")
    assert b["tokens"].dtype == torch.int32 and tuple(b["tokens"].shape) == (600, 64)
    t = b["tokens"].numpy()
    assert t.min() >= 0 and t.max() < V
    np.testing.assert_array_equal(b["labels"].numpy()[:, :-1], t[:, 1:])
    np.testing.assert_array_equal(data.batch_for(dc, 5)["tokens"], t)
    assert not np.array_equal(data.batch_for(dc, 6)["tokens"], t)
    jt = np.asarray(jdata.batch_for(jdata.DataConfig(vocab=V, seq_len=64, global_batch=600, seed=7), 5)["tokens"])
    for tok in (t, jt):
        kinds = _kinds(tok, V)
        frac = np.bincount(kinds, minlength=3) / len(kinds)
        assert np.all(np.abs(frac - 1 / 3) < 0.07), frac
        assert abs(tok[kinds == 2].mean() / V - 1 / 3) < 0.02
    it = data.host_batches(dc, start_step=5)
    np.testing.assert_array_equal(next(it)["tokens"], t)
    emb = data.synthetic_batch(dataclasses.replace(dc, global_batch=2, frontend_dim=8), 0, device="cpu")
    assert emb["embeds"].dtype == torch.bfloat16 and tuple(emb["embeds"].shape) == (2, 64, 8)


def test_entry_points_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    dc = data.DataConfig(vocab=10, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        data.synthetic_batch(dc, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--arch", ARCH, "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="torchrun"):  # --model-axis 2 needs a world of ranks
        main(["--arch", ARCH, "--smoke", "--steps", "1", "--model-axis", "2", "--device", "cpu"])
