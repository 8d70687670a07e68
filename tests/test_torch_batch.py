"""Port parity: batched solves (``solve_many``, ``BatchPlan``, ``PadPolicy``), CPU.

``repro_torch.solver.solve_many(..., device="cpu")`` against the JAX
package's ``solve_many`` (jnp backend) on the same numpy inputs: a stacked
array, a list of mixed n, a dict tree, a (2, 3, n, n) batch shape, an empty
(0, n, n) leaf, padded buckets (with a partial spectrum), ``batch_multiple``
and the inverse roots, padded and not.  Eigenvalues at atol 1e-5 · max|w|,
eigenvectors sign-aligned at atol 1e-4, inverse roots at 2e-4 · max|X|, as
tests/test_torch_plan.py holds single solves.  Only tolerance is claimed: the
reference's own batched path is not bit-identical to its plan loop (ROADMAP
Queue 3).  Plus ``PadPolicy`` validation, the ``batch_plan`` cache, the
operand, spectrum and device errors.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from conftest import random_psd, random_symmetric  # noqa: E402
from repro.solver import EvdConfig as JaxConfig  # noqa: E402
from repro.solver import PadPolicy as JaxPad  # noqa: E402
from repro.solver import by_count as jax_by_count  # noqa: E402
from repro.solver import solve_many as jax_solve_many  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.solver import (  # noqa: E402
    BatchPlan,
    EvdConfig,
    PadPolicy,
    batch_plan,
    by_count,
    plan,
    solve_many,
)

JCFG = JaxConfig(backend="jnp", b=4, nb=16)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _syms(rng, *shape):
    a = rng.normal(size=shape).astype(np.float32)
    return a + np.swapaxes(a, -1, -2)


def _psds(rng, count, n):
    return np.stack([random_psd(rng, n) for _ in range(count)])


def _check_eigh(got, want):
    """Eigenvalues at 1e-5 · max|w|; eigenvector columns sign-aligned at 1e-4."""
    wt, Vt = _np(got[0]), _np(got[1])
    wj, Vj = _np(want[0]), _np(want[1])
    assert wt.shape == wj.shape and Vt.shape == Vj.shape
    if wt.size == 0:
        return
    scale = float(np.abs(wj).max())
    np.testing.assert_allclose(wt, wj, atol=1e-5 * scale)
    s = np.sign(np.sum(Vt * Vj, axis=-2, keepdims=True))
    np.testing.assert_allclose(Vt * s, Vj, atol=1e-4)


def _check(got, want, op):
    if op == "eigh":
        _check_eigh(got, want)
    elif op == "eigvals":
        wt, wj = _np(got), _np(want)
        assert wt.shape == wj.shape
        np.testing.assert_allclose(wt, wj, atol=1e-5 * max(float(np.abs(wj).max(initial=0)), 1e-30))
    else:
        Xt, Xj = _np(got), _np(want)
        assert Xt.shape == Xj.shape
        np.testing.assert_allclose(Xt, Xj, atol=2e-4 * float(np.abs(Xj).max()))


def _cases():
    rng = np.random.default_rng(7)
    part = (by_count(3, largest=False), jax_by_count(3, largest=False))
    return {
        "stacked": (_syms(rng, 4, 16, 16), {}, None),
        "mixed_list": ([_syms(rng, 16, 16), _syms(rng, 24, 24), _syms(rng, 16, 16)], {}, None),
        "dict_tree": ({"a": _syms(rng, 2, 16, 16), "b": [_syms(rng, 8, 8)]}, {}, None),
        "batch_shape": (_syms(rng, 2, 3, 16, 16), {}, None),
        "empty_leaf": ([np.zeros((0, 16, 16), np.float32), _syms(rng, 16, 16)], {}, None),
        "padded": ([_syms(rng, 12, 12), _syms(rng, 2, 20, 20), _syms(rng, 32, 32)],
                   dict(pad=(32,)), None),
        "padded_partial": ([_syms(rng, 12, 12), _syms(rng, 20, 20)], dict(pad=(32,)), part),
        "batch_multiple": (_syms(rng, 3, 16, 16), dict(multiple=4), None),
        "eigvals_partial": ([_syms(rng, 16, 16), _syms(rng, 2, 24, 24)],
                            dict(op="eigvals"), (by_count(4), jax_by_count(4))),
        "inverse_root": (_psds(rng, 3, 16), dict(op="inverse_pth_root"), None),
        "padded_inverse_root": ([_psds(rng, 2, 12), _psds(rng, 1, 16)],
                                dict(op="inverse_pth_root", pad=(16,)), None),
    }


CASES = _cases()


@pytest.mark.parametrize("case", list(CASES))
def test_solve_many_matches_jax(case):
    mats, opts, spectra = CASES[case]
    op = opts.get("op", "eigh")
    jcfg = JCFG if spectra is None else dataclasses.replace(JCFG, spectrum=spectra[1])
    cfg = interop.evd_config(dataclasses.asdict(jcfg))
    if spectra is not None:
        assert cfg.spectrum == spectra[0]
    jpad = JaxPad(bucket_sizes=opts.get("pad"), batch_multiple=opts.get("multiple", 1))
    pad = interop.pad_policy(dataclasses.asdict(jpad))
    kw = dict(op=op, p=4, eps=1e-6)
    got = solve_many(mats, cfg, pad=pad, device="cpu", **kw)
    want = jax_solve_many(
        [jnp.asarray(x) for x in mats] if isinstance(mats, list)
        else {"a": jnp.asarray(mats["a"]), "b": [jnp.asarray(mats["b"][0])]} if isinstance(mats, dict)
        else jnp.asarray(mats),
        jcfg, pad=jpad, **kw,
    )
    if isinstance(mats, dict):
        assert set(got) == {"a", "b"} and isinstance(got["b"], list)
        pairs = [(got["a"], want["a"]), (got["b"][0], want["b"][0])]
    elif isinstance(mats, list):
        assert isinstance(got, list) and len(got) == len(mats)
        pairs = list(zip(got, want))
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        _check(g, w, op)


def test_pad_policy_validation():
    for bad in (dict(bucket_sizes=()), dict(bucket_sizes=(0, 32)), dict(batch_multiple=0),
                dict(ridge=0.0)):
        with pytest.raises(ValueError):
            PadPolicy(**bad)
        with pytest.raises(ValueError):
            JaxPad(**bad)
    assert PadPolicy(bucket_sizes=(64, 32)).bucket_sizes == (32, 64)
    assert PadPolicy().bucket_for(17) == 17
    assert PadPolicy(bucket_sizes=(32, 64)).bucket_for(17) == 32
    with pytest.raises(ValueError, match="larger bucket"):
        PadPolicy(bucket_sizes=(32,)).bucket_for(48)


def test_interop_pad_policy_roundtrip():
    for jpad in (JaxPad(), JaxPad(bucket_sizes=(64, 32), batch_multiple=4, ridge=0.5, donate=True)):
        pad = interop.pad_policy(dataclasses.asdict(jpad))
        assert dataclasses.asdict(pad) == dataclasses.asdict(jpad)
    assert interop.pad_policy(dataclasses.asdict(JaxPad())) == PadPolicy()


def test_batch_plan_cache_identity():
    cfg = EvdConfig(b=4, nb=16)
    b1 = batch_plan(32, 4, torch.float32, cfg, device="cpu")
    assert isinstance(b1, BatchPlan)
    assert batch_plan(32, 4, "float32", EvdConfig(b=4, nb=16), device="cpu") is b1
    assert b1.base is plan(32, torch.float32, cfg, device="cpu")
    assert batch_plan(32, 5, torch.float32, cfg, device="cpu") is not b1
    assert batch_plan(48, 4, torch.float32, cfg, device="cpu") is not b1
    assert "batch=4" in b1.describe() and "device=cpu" in b1.describe()
    with pytest.raises(ValueError):
        batch_plan(32, 0, torch.float32, cfg, device="cpu")


def test_batch_plan_rejects_mismatched_operand():
    rng = np.random.default_rng(3)
    bpl = batch_plan(16, 3, torch.float32, EvdConfig(b=4, nb=16), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        bpl(torch.as_tensor(_syms(rng, 4, 16, 16)))
    with pytest.raises(ValueError, match="shape"):
        bpl(torch.as_tensor(_syms(rng, 3, 24, 24)))
    with pytest.raises(ValueError, match="dtype"):
        bpl.inverse_pth_root(torch.zeros((3, 16, 16), dtype=torch.bfloat16), 4)
    part = batch_plan(16, 2, torch.float32, EvdConfig(b=4, nb=8, spectrum=by_count(4)), device="cpu")
    with pytest.raises(ValueError, match="full spectrum"):
        part.inverse_pth_root(torch.eye(16).expand(2, 16, 16), 4)
    with pytest.raises(ValueError, match="full spectrum"):
        solve_many(np.eye(16, dtype=np.float32)[None], EvdConfig(spectrum=by_count(4)),
                   op="inverse_pth_root", device="cpu")
    with pytest.raises(ValueError, match="trailing square"):
        solve_many([np.zeros((4, 5), np.float32)], device="cpu")
    with pytest.raises(ValueError, match="unknown op"):
        solve_many([np.eye(4, dtype=np.float32)], op="svd", device="cpu")


def test_single_plan_is_a_bucket_of_one():
    """``EvdPlan.__call__`` runs the bucket executor with B = 1, so it gives
    the bits of a one-matrix batch plan; a bucket of three agrees with the
    per-matrix loop."""
    a = _syms(np.random.default_rng(5), 3, 16, 16)
    cfg = EvdConfig(b=4, nb=16)
    pl = plan(16, torch.float32, cfg, device="cpu")
    w1, V1 = pl(torch.as_tensor(a[0]))
    wb, Vb = batch_plan(16, 1, torch.float32, cfg, device="cpu")(torch.as_tensor(a[:1]))
    assert torch.equal(w1, wb[0]) and torch.equal(V1, Vb[0])
    w3, V3 = batch_plan(16, 3, torch.float32, cfg, device="cpu")(torch.as_tensor(a))
    for i in range(3):
        _check_eigh((w3[i], V3[i]), pl(torch.as_tensor(a[i])))


def test_solve_many_leaves_its_input_alone():
    a = torch.as_tensor(_syms(np.random.default_rng(6), 2, 16, 16))
    a[0, 0, 1] += 1.0  # not symmetric: the executor symmetrizes its own copy
    before = a.clone()
    solve_many(a, EvdConfig(b=4, nb=16), pad=PadPolicy(donate=True))
    assert torch.equal(a, before)


def test_solve_many_devices():
    a = random_symmetric(np.random.default_rng(8), 16)
    with pytest.raises(RuntimeError, match="torch.distributed process group"):
        solve_many([a], devices=("cpu",), device="cpu")
    with pytest.raises(ValueError, match="device"):
        solve_many([torch.as_tensor(a)], device="meta")


def test_solve_many_numpy_leaves_go_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = random_symmetric(np.random.default_rng(9), 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve_many([a], EvdConfig(b=4, nb=16))
    w, V = solve_many([a], EvdConfig(b=4, nb=16), device="cpu")[0]
    assert w.device.type == "cpu" and tuple(V.shape) == (16, 16)
    # Tensor leaves run where they lie.
    w2, _ = solve_many(torch.as_tensor(a)[None], EvdConfig(b=4, nb=16))
    assert torch.equal(w2[0], w)
