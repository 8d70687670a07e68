"""Kernels A–E as ``repro_torch`` operators (``repro_torch.kernels.library``)
and their work formulas (``repro_torch.kernels.work``), on the CPU.

* Each operator's fake implementation gives the plain version's outputs'
  shapes, dtypes and strides (the plain version run on real CPU tensors of
  the same shapes).
* Each work formula equals the expression ``chip_smoke.py`` phase 2 used
  for its ``bound_ms`` before the formulas moved into the package, for
  three shapes each; where phase 2 read a count from the data (kernel B's
  active slots, kernel C's live reflectors), that count is read here from
  a plain chase of a random band and equals the schedule's.
* Under ``FakeTensorMode`` with fake CUDA tensors, the walk
  (``analysis.StepWalk``) and ``FlopCounterMode`` count each call exactly
  as the formula says, and its bytes as inputs read plus outputs written
  (kernel A's mutated view once).
* ``torch.library.opcheck`` passes for each operator's schema and fake
  implementation, registered under a scratch namespace with the plain
  version as its CPU implementation (the card runs ``opcheck`` on the
  kernels themselves: chip_smoke.py phase 14).
* The registry's ``cuda`` backend resolves to the operators; a CPU tensor
  raises.
* A refresh, ``solve_many(..., op="inverse_pth_root")`` of 3 matrices of
  128, on fake CUDA tensors (``tests/torch_fake_cuda.py``: the device probe
  and Python indexing, a test seam) calls 2 A + 1 B + 1 C a matrix and
  lists its data-dependent loops.
* On fake tensors a loop of identical trips runs one trip counted once a
  trip (``trace.repeated`` / ``trace.map_lanes``): a refresh of 2 matrices
  of 16, on fake CPU tensors (the plain chase, back-transform, bisection,
  inverse iteration and Jacobi) and on fake CUDA tensors (the operators),
  counts exactly what the same refresh counts with every trip and every
  lane run: FLOPs, HBM bytes, peak live bytes, ops and the loops.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

import torch_fake_cuda  # noqa: E402
from repro_torch.analysis import analyze_step  # noqa: E402
from repro_torch.backend import registry  # noqa: E402
from repro_torch.core.backtransform import backtransform_wy_xla, sweep_major_log  # noqa: E402
from repro_torch.core.bulge_chasing import chase_wavefront, chase_wavefront_slices  # noqa: E402
from repro_torch.kernels import library, ref, work  # noqa: E402
from repro_torch.kernels.panel import panel_qr_body  # noqa: E402


def _sym(n, seed):
    a = np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
    return torch.as_tensor(a + a.T)


def _band(n, b, seed):
    a = _sym(n, seed)
    i = torch.arange(n)
    a[(i[:, None] - i[None, :]).abs() > b] = 0.0
    return a


def _rand(*shape, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


# name -> (operator call on the inputs, the plain version's outputs, the inputs)
def _cases(n, b, w):
    A = _sym(n, 1)
    band = _band(n, b, 2)
    T, log = chase_wavefront(band, b, True)
    vs, taus = sweep_major_log(log)
    X = _rand(n, n // 2, seed=3)
    Y, Z = _rand(n - w, w, seed=4), _rand(n - w, w, seed=5)
    C = A[w:, w:]
    P = _rand(n - b, b, seed=6)
    return {
        "fused_panel_update": (lambda A: library._ops.fused_panel_update(A, b, w),
                               lambda A: ref.fused_panel_update_ref(A, b, w)[1:], (A,)),
        "bulge_wavefront": (lambda B: library._ops.bulge_wavefront(B, b),
                            lambda B: (lambda T, lg: (T, lg.vs, lg.taus, lg.row0))(*chase_wavefront_slices(B, b, True)),
                            (band,)),
        "bulge_chase": (lambda B: library._ops.bulge_chase(B, b), lambda B: chase_wavefront(B, b), (band,)),
        "backtransform_wy": (lambda X, vs, taus: library._ops.backtransform_wy(X, vs, taus, b, False),
                             lambda X, vs, taus: backtransform_wy_xla(X, vs, taus, b=b), (X, vs, taus)),
        "syr2k": (lambda Z, Y, C: library._ops.syr2k(Z, Y, C, -1.0),
                  lambda Z, Y, C: ref.syr2k_ref(Z, Y, C, alpha=-1.0), (Z, Y, C)),
        "trailing_update": (lambda C, Y, Z: library._ops.trailing_update(C, Y, Z),
                            lambda C, Y, Z: ref.syr2k_ref(Z, Y, C, alpha=-1.0), (C, Y, Z)),
        "panel_qr": (lambda P: library._ops.panel_qr(P), lambda P: panel_qr_body(P, b, lapack_sign=False), (P,)),
    }


def _tensors(out):
    return out if isinstance(out, (tuple, list)) else (out,)


def _fake_cuda(ts):
    """Fake CUDA tensors of ``ts``' shapes, dtypes and strides (views keep
    their base: ``C`` is ``A[w:, w:]``)."""
    return tuple(torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="cuda") for t in ts)


SHAPES = [(32, 4, 8), (64, 8, 16), (128, 8, 64)]


@pytest.mark.parametrize("n,b,w", SHAPES)
@pytest.mark.parametrize("name", library.OPERATORS)
def test_fake_outputs_match_the_plain_version(name, n, b, w):
    op, plain, ins = _cases(n, b, w)[name]
    want = _tensors(plain(*[t.clone() if name == "fused_panel_update" else t for t in ins]))
    with FakeTensorMode():
        got = _tensors(op(*_fake_cuda(ins)))
    assert len(got) == len(want)
    for g, p in zip(got, want):
        assert (g.shape, g.dtype, g.stride()) == (p.shape, p.dtype, p.stride()), name
        assert g.device.type == "cuda"


def _phase2(name, n, b, w):
    """chip_smoke.py phase 2's (bytes, FLOPs) expressions as they stood,
    with its data counts read from a plain chase of a random band."""
    if name == "fused_panel_update":
        m, q = n, w // b
        flops = sum(2.0 * m * (m - (j + 1) * b) * b + 12.0 * m * j * b * b for j in range(q))
        return (2.0 * m * m + m * w + q * b * b) * 4, [flops, 2.0 * (m - w) * (m - w) * w]
    _, lp = chase_wavefront_slices(_band(n, b, 7), b, True)
    if name == "bulge_wavefront":
        n_ops = int((lp.row0 < n).sum())
        Wn, An = lp.taus.shape
        return (2.0 * n * n + Wn * An * (b + 2)) * 4, [26.0 * b * b * n_ops]
    if name == "backtransform_wy":
        vs, taus = sweep_major_log(lp)
        S, K, _ = vs.shape
        n_refl = int((taus != 0).sum())
        return (2.0 * n * n + S * K * (b + 1)) * 4, [4.0 * b * n_refl * n]
    if name == "syr2k":
        mt, lower = n - w, (n - w) * (n - w + 1) / 2
        return (2.0 * mt * w + lower + mt * mt) * 4, [4.0 * w * lower]
    m_e = n - b
    flops = sum(3.0 * (m_e - j) + 4.0 * (m_e - j) * (b - 1 - j) + 2.0 * (m_e - j) * j for j in range(b)) + b ** 3 / 3.0
    return (2.0 * m_e * b + 2.0 * b * b + b) * 4, [flops]


def _formula(name, n, b, w):
    if name == "fused_panel_update":
        return work.fused_panel_update(n, w, b)
    if name == "bulge_wavefront":
        return work.bulge_wavefront(n, b)
    if name == "backtransform_wy":
        S, K = n - 2, (n - 3) // b + 1
        return work.backtransform_wy(n, n, S, K, b)
    if name == "syr2k":
        return work.syr2k(n - w, w)
    return work.panel_qr(n - b, b)


@pytest.mark.parametrize("n,b,w", SHAPES)
@pytest.mark.parametrize("name", ["fused_panel_update", "bulge_wavefront", "backtransform_wy", "syr2k", "panel_qr"])
def test_work_formula_equals_phase2_expression(name, n, b, w):
    nbytes, flops = _phase2(name, n, b, w)
    got = _formula(name, n, b, w)
    assert got.bytes == nbytes
    assert [f for f, _ in got.flops] == flops


def test_chase_ops_are_the_schedule_active_slots():
    from repro_torch.core.bulge_chasing import wavefront_schedule

    for n, b in ((3, 2), (33, 4), (64, 8), (130, 8), (256, 8)):
        assert work.chase_ops(n, b) == int(wavefront_schedule(n, b)[1].sum())


@pytest.mark.parametrize("n,b,w", SHAPES)
@pytest.mark.parametrize("name", library.OPERATORS)
def test_walk_counts_the_formula_on_fake_cuda(name, n, b, w):
    op, _, ins = _cases(n, b, w)[name]
    with FakeTensorMode():
        args = _fake_cuda(ins)
        out, rec = analyze_step(op, *args)
        with FlopCounterMode(display=False) as fc:
            op(*args)
    want = {
        "fused_panel_update": lambda: work.fused_panel_update(n, w, b),
        "bulge_wavefront": lambda: work.bulge_wavefront(n, b),
        "bulge_chase": lambda: work.bulge_wavefront(n, b, log=False),
        "backtransform_wy": lambda: work.backtransform_wy(n, n // 2, *ins[1].shape[:2], b),
        "syr2k": lambda: work.syr2k(n - w, w),
        "trailing_update": lambda: work.syr2k(n - w, w),
        "panel_qr": lambda: work.panel_qr(n - b, b),
    }[name]()
    nbytes = sum(t.numel() * t.element_size() for t in args) + sum(
        t.numel() * t.element_size() for t in _tensors(out))
    assert rec["flops"] == fc.get_total_flops() == round(want.total_flops) > 0
    assert rec["hbm_bytes"] == nbytes
    assert rec["operators"] == {name: {"count": 1, "flops": rec["flops"], "bytes": nbytes}}


_PLAIN = {
    "fused_panel_update": lambda Bv, b, w: ref.fused_panel_update_ref(Bv, b, w)[1:],
    "bulge_wavefront": lambda B, b: (lambda T, lg: (T, lg.vs, lg.taus, lg.row0))(*chase_wavefront_slices(B, b, True)),
    "bulge_chase": lambda B, b: chase_wavefront(B, b),
    "backtransform_wy": lambda X, vs, taus, b, t: backtransform_wy_xla(X, vs, taus, b=b, transpose=t),
    "syr2k": lambda A, B, C, alpha: ref.syr2k_ref(A, B, C, alpha=alpha),
    "trailing_update": lambda C, Y, Z: ref.syr2k_ref(Z, Y, C, alpha=-1.0),
    "panel_qr": lambda P: panel_qr_body(P, P.shape[1], lapack_sign=False),
}


@pytest.fixture(scope="module")
def plain_ops():
    """The operators' schemas and fake implementations under a scratch
    namespace, their plain versions as the CPU implementation."""
    ns = "repro_torch_opcheck"
    lib = torch.library.Library(ns, "DEF")
    for name, (schema, _, fake, _) in library._OPS.items():
        lib.define(schema)
        lib.impl(name, _PLAIN[name], "CPU")
        torch.library.register_fake(f"{ns}::{name}", fake, lib=lib)
    yield getattr(torch.ops, ns)
    lib._destroy()


@pytest.mark.parametrize("name", library.OPERATORS)
def test_opcheck_schema_and_fake(plain_ops, name):
    n, b, w = 64, 8, 16
    ins = _cases(n, b, w)[name][2]
    args = {"fused_panel_update": lambda A: (A.clone()[w:, w:], b, w - 8), "bulge_wavefront": lambda B: (B, b),
            "bulge_chase": lambda B: (B, b), "backtransform_wy": lambda X, vs, taus: (X, vs, taus, b, True),
            "syr2k": lambda Z, Y, C: (Z, Y, C, -1.0), "trailing_update": lambda C, Y, Z: (C, Y, Z),
            "panel_qr": lambda P: (P,)}[name](*ins)
    result = torch.library.opcheck(getattr(plain_ops, name), args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_cuda_backend_resolves_to_the_operators_and_refuses_cpu():
    pairs = {"fused_panel_update": library.fused_panel_update, "bulge_wavefront": library.bulge_wavefront,
             "bulge_chase": library.bulge_chase, "backtransform_wy": library.backtransform_wy,
             "syr2k": library.syr2k, "trailing_update": library.trailing_update, "panel_qr": library.panel_qr}
    assert set(pairs) == set(registry.OPS)
    for op, fn in pairs.items():
        assert registry.resolve(op, "cuda") is fn
        assert registry.resolve(op, "torch") is not fn
    A = _sym(64, 0)
    with pytest.raises(NotImplementedError, match="repro_torch::fused_panel_update.*CPU"):
        registry.resolve("fused_panel_update", "cuda")(A, 8, 16)
    with pytest.raises(NotImplementedError, match="repro_torch::bulge_chase"):
        registry.resolve("bulge_chase", "cuda")(A, 8)
    with pytest.raises(NotImplementedError, match="repro_torch::syr2k"):
        registry.resolve("syr2k", "cuda")(A[:, :8], A[:, 8:16])


def test_refresh_on_fake_cuda_calls_the_operators():
    from repro_torch.solver import EvdConfig, solve_many

    B = 3
    with torch_fake_cuda.card_probe(), FakeTensorMode(), torch_fake_cuda.FakeCudaIndexing():
        x = torch.empty((B, 128, 128), device="cuda")
        out, rec = analyze_step(lambda: solve_many(x, EvdConfig(b=8, nb=64), op="inverse_pth_root"))
    assert out.shape == (B, 128, 128) and out.device.type == "cuda"
    calls = {k: v["count"] for k, v in rec["operators"].items()}
    assert calls == {"fused_panel_update": 2 * B, "bulge_wavefront": B, "backtransform_wy": B}
    assert rec["operators"]["fused_panel_update"]["flops"] == B * round(
        work.fused_panel_update(128, 64, 8).total_flops + work.fused_panel_update(64, 56, 8).total_flops)
    loops = {d["site"]: d for d in rec["data_dependent"]}
    assert set(loops) == {"core/jacobi.py:jacobi_eigh", "core/tridiag_eig.py:_qr"}
    assert loops["core/jacobi.py:jacobi_eigh"]["trips"] == 8  # _RITZ_SWEEPS, every matrix
    assert loops["core/tridiag_eig.py:_qr"]["trips"] == 0


@contextlib.contextmanager
def _every_trip(n, like):
    yield range(n)


def _every_lane(fn, items, like):
    return [fn(x) for x in items]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_compressed_loops_count_every_trip(monkeypatch, device):
    import repro_torch.core.backtransform as bt
    import repro_torch.core.bulge_chasing as bc
    import repro_torch.core.jacobi as jc
    import repro_torch.core.tridiag_eig as te
    import repro_torch.solver.plan as pl
    from repro_torch.solver import EvdConfig, solve_many

    def refresh():
        seams = (torch_fake_cuda.card_probe(), FakeTensorMode(), torch_fake_cuda.FakeCudaIndexing()) \
            if device == "cuda" else (FakeTensorMode(),)
        with contextlib.ExitStack() as stack:
            for seam in seams:
                stack.enter_context(seam)
            x = torch.empty((2, 16, 16), device=device)
            kw = {"device": "cpu"} if device == "cpu" else {}
            return analyze_step(lambda: solve_many(x, EvdConfig(b=4, nb=8), op="inverse_pth_root", **kw))[1]

    compressed = refresh()
    for mod in (te, bc, jc, bt, pl):
        for name, every in (("repeated", _every_trip), ("map_lanes", _every_lane)):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, every)
    full = refresh()
    keys = ("flops", "hbm_bytes", "peak_live_bytes", "ops", "operators", "data_dependent")
    assert {k: compressed[k] for k in keys} == {k: full[k] for k in keys}
    assert compressed["flops"] > 0 and compressed["data_dependent"][0]["trips"] == 8
