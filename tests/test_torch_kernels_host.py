"""The CUDA kernels' arithmetic and indexing, run on the CPU by emulation.

Each ``src/repro_torch/csrc/*.cu`` (kernels A to E) is compiled with g++ against
``tests/cuda_host/cuda_runtime.h``, which runs a launch's clusters one after
another (a plain launch is a cluster of one CTA) with one host thread per
CUDA thread; the CTAs of a cluster run together, each with its own shared
memory, as kernel A's panel QR needs, and so do all CTAs of kernel B's
persistent grid, which hand sweeps to each other through flags.  The
exported launchers are called through ctypes with CPU tensors and held
against the plain PyTorch versions at the tolerances of
tests/test_torch_kernels_cuda.py.  Clusters never overlap here, so races
between them are the card's tests' job (``python -m pytest -m cuda``);
skipped where g++ is missing.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.core.backtransform import backtransform_wy_xla, sweep_major_log  # noqa: E402
from repro_torch.core.band_reduction import build_stage_schedule  # noqa: E402
from repro_torch.core.bulge_chasing import (  # noqa: E402
    ChaseLog, chase_wavefront_slices, max_active_sweeps, num_wavefronts,
)
from repro_torch.kernels import backtransform as kc  # noqa: E402
from repro_torch.kernels import bulge as kb  # noqa: E402
from repro_torch.kernels import fused_panel as ka  # noqa: E402
from repro_torch.kernels import panel as ke  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import syr2k as kd  # noqa: E402
from repro_torch.kernels.cuda_lib import CSRC  # noqa: E402
from repro_torch.kernels.limits import limit  # noqa: E402

SHIM = Path(__file__).resolve().parent / "cuda_host"
SMEM = limit("PANEL_QR_SMEM")


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for host emulation")
    out = tmp_path_factory.mktemp("cuda_host")
    procs = {}
    sources = {name: CSRC / f"{name}.cu" for name in ("fused_panel", "bulge", "backtransform", "syr2k", "panel")}
    sources["mma_probe"] = SHIM / "mma_probe.cu"
    sources["mma_tf32_probe"] = SHIM / "mma_tf32_probe.cu"
    # Kernel A with its GEMV the symmetric product at every m (the row walk's
    # range of m empty), to reach the product's tile edges at small m.
    sources["fused_panel_tiles"] = CSRC / "fused_panel.cu"
    for name, src in sources.items():
        so = out / f"{name}.so"
        cmd = [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
               f"-I{SHIM}", f"-I{CSRC}", "-x", "c++", str(src), "-o", str(so)]
        if name == "fused_panel_tiles":
            cmd.insert(1, "-DREPRO_GEMV_ROWS_MAX=0")
        procs[name] = (subprocess.Popen(cmd, stderr=subprocess.PIPE, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err
        libs[name] = ctypes.CDLL(str(so))
    fa = libs["fused_panel"].fused_panel_update_launch
    fb = libs["bulge"].bulge_wavefront_launch
    fc = libs["backtransform"].backtransform_wy_launch
    fd = libs["syr2k"].syr2k_launch
    fe = libs["panel"].panel_qr_launch
    for fn, mod in ((fa, ka), (fb, kb), (fc, kc), (fd, kd), (fe, ke)):
        fn.argtypes = mod._ARGTYPES
        fn.restype = ctypes.c_int
    wa = libs["fused_panel"].fused_panel_update_workspace
    wa.argtypes = ka._WORKSPACE_ARGTYPES
    wa.restype = ctypes.c_longlong
    fa = (fa, wa)
    ws = libs["backtransform"].backtransform_wy_workspace
    ws.argtypes = kc._WORKSPACE_ARGTYPES
    ws.restype = ctypes.c_longlong
    wb = libs["bulge"].bulge_wavefront_workspace
    wb.argtypes = kb._WORKSPACE_ARGTYPES
    wb.restype = ctypes.c_longlong
    in_turn = libs["bulge"].emu_run_ctas_in_turn
    in_turn.argtypes = [ctypes.c_int]
    mma = libs["mma_probe"].mma_probe_launch
    mma.argtypes = [ctypes.c_void_p] * 3
    mma.restype = ctypes.c_int
    tf32 = libs["mma_tf32_probe"].mma_tf32_probe_launch
    tf32.argtypes = [ctypes.c_void_p] * 4
    tf32.restype = ctypes.c_int
    plan = libs["panel"].panel_qr_plan
    plan.argtypes = ke._PLAN_ARGTYPES
    plan.restype = ctypes.c_int
    ft = libs["fused_panel_tiles"].fused_panel_update_launch
    ft.argtypes = ka._ARGTYPES
    ft.restype = ctypes.c_int
    wt = libs["fused_panel_tiles"].fused_panel_update_workspace
    wt.argtypes = ka._WORKSPACE_ARGTYPES
    wt.restype = ctypes.c_longlong
    return fa, fb, fc, fd, fe, ws, wb, in_turn, mma, tf32, plan, (ft, wt)


def _sym(n, seed):
    a = np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
    return torch.tensor(a + a.T)


def _band(n, b, seed):
    a = _sym(n, seed)
    i = torch.arange(n)
    a[(i[:, None] - i[None, :]).abs() > b] = 0.0
    return a


def _rel(x, y):
    return float((x.double() - y.double()).abs().max() / max(float(y.abs().max()), 1.0))


def _fused(fa, Bv, b, w, qr_smem=SMEM, cluster=None):
    """The launcher's buffers (repro_torch.kernels.fused_panel), on the CPU."""
    fa, wa = fa
    m = Bv.shape[0]
    cluster = ka.cluster_size(m, b) if cluster is None else cluster
    buf = ka.buffers(m, w, b, cluster, "cpu", wa)
    err = fa(Bv.data_ptr(), Bv.stride(0), 0, 1, m, w, b, *(t.data_ptr() for t in buf.values()),
             qr_smem, cluster, None)
    assert err == 0
    return Bv, buf["V"][0], buf["Ts"][0]


_FUSED_CASES = [
    (48, 16, 8, SMEM, "launched"), (40, 32, 8, SMEM, "launched"), (36, 12, 4, SMEM, "launched"),
    (72, 32, 8, 0, "launched"), (48, 32, 16, SMEM, "launched"),
    # panel_xred over 2 column chunks and 3 row chunks; panel_gemv the row
    # walk (128 < m), then the symmetric product on 5 x 5 tiles of 64, the
    # last one ragged (300 = 4 x 64 + 44), r0 inside tile 0 and the rows of
    # M above r0 from the column products alone
    (300, 48, 8, SMEM, "launched"), (300, 48, 8, SMEM, "tiles"),
    # b = 16 on 3 x 3 tiles of 64 (m ragged)
    (150, 32, 16, SMEM, "launched"), (150, 32, 16, SMEM, "tiles"),
    # b = 4 on the 8-wide instantiation, rows not 16-byte aligned (m odd):
    # Bv read by 4-byte copies
    (133, 16, 4, SMEM, "launched"), (133, 16, 4, SMEM, "tiles"),
]


@pytest.mark.parametrize(
    "m,w,b,qr_smem,gemv",
    _FUSED_CASES,
    # "launched": kernel A as built for the card (its GEMV the row walk for
    # 128 < m <= 4096); "tiles": the symmetric product at every m.
    ids=[f"{m}-{w}-{b}-{q}" + ("" if g == "launched" else f"-{g}") for m, w, b, q, g in _FUSED_CASES],
)
def test_fused_panel_host(host, m, w, b, qr_smem, gemv):
    A = _sym(m, m)
    Bk, Vk, Tk = _fused(host[0] if gemv == "launched" else host[11], A.clone(), b, w, qr_smem)
    Bp, Vp, Tp = ref.fused_panel_update_ref(A.clone(), b, w)
    tol = 1e-5 * max(8.0, m ** 0.5)
    assert _rel(Bk, Bp) < tol and _rel(Vk, Vp) < tol and _rel(Tk, Tp) < tol
    # Kernel A's GEMV reads only the lower triangle of the view it is given,
    # so the next block's trailing view must come out bitwise symmetric.
    assert torch.equal(Bk[w:, w:], Bk[w:, w:].mT)


@pytest.mark.parametrize(
    "m,w,b,cluster,qr_smem",
    [
        (48, 16, 8, 2, SMEM),   # 40 panel rows, 20 per CTA
        (45, 20, 4, 3, SMEM),   # 41 rows: slices of 14, 14, 13
        (40, 32, 8, 4, SMEM),   # last panel: 8 rows over 4 CTAs, pivots on 4 CTAs
        (37, 12, 4, 5, 0),      # slices in global memory, one CTA left empty
        (24, 16, 8, 3, SMEM),   # m small enough for the last DBR blocks
        (70, 28, 7, 4, SMEM),   # b = 7 on the 8-wide instantiation
    ],
)
def test_fused_panel_host_cluster_splits(host, m, w, b, cluster, qr_smem):
    """The panel QR's rows split over clusters of 2-5 CTAs: uneven slices,
    pivot rows on several CTAs, empty CTAs, slices in global memory."""
    A = _sym(m, m + cluster)
    Bk, Vk, Tk = _fused(host[0], A.clone(), b, w, qr_smem, cluster)
    Bp, Vp, Tp = ref.fused_panel_update_ref(A.clone(), b, w)
    tol = 1e-5 * max(8.0, m ** 0.5)
    assert _rel(Bk, Bp) < tol and _rel(Vk, Vp) < tol and _rel(Tk, Tp) < tol


def test_fused_panel_host_schedule_on_views(host):
    """Every block of a real schedule, in place on views of one matrix."""
    n, b, nb = 80, 4, 32
    A = _sym(n, 1)
    Bk, Bp = A.clone(), A.clone()
    for e in build_stage_schedule(n, b, nb).entries:
        _fused(host[0], Bk[e.ci :, e.ci :], b, e.w)
        ref.fused_panel_update_ref(Bp[e.ci :, e.ci :], b, e.w)
    assert _rel(Bk, Bp) < 1e-4


def _chase(host, B, b, ctas, with_log=True, stats=None):
    """Kernel B's launcher on a copy of the band ``B`` (n, n), or of a
    bucket of bands (count, n, n), with a grid of ``ctas`` CTAs
    (``stats``: its 3 counters, or None)."""
    n = B.shape[-1]
    lead = tuple(B.shape[:-2])
    count = B.shape[0] if lead else 1
    A, W = max_active_sweeps(n, b), num_wavefronts(n, b)
    T = B.clone()
    # NaN in every log slot: the kernel must write the inactive ones too.
    vs = torch.full(lead + (W, A, b), float("nan"))
    taus = torch.full(lead + (W, A), float("nan"))
    row0 = torch.full(lead + (W, A), -1, dtype=torch.int32)
    work = torch.zeros(host[6](n, count) // 4, dtype=torch.int32)
    assert host[1](T.data_ptr(), n, b, A, ctas, vs.data_ptr(), taus.data_ptr(), row0.data_ptr(),
                   int(with_log), work.data_ptr(), count, None if stats is None else stats.data_ptr(),
                   None) == 0
    # every sweep taken, then one empty ticket per CTA
    assert int(work[-1]) == count * (n - 2) + ctas
    return T, ChaseLog(vs, taus, row0, n, b)


@pytest.mark.parametrize("together", [False, True], ids=["ctas_in_turn", "ctas_together"])
@pytest.mark.parametrize(
    "n,b,ctas",
    [
        (16, 4, 1),  # one CTA takes every sweep
        (33, 4, 2),  # 2 CTAs < A = 4 sweeps in flight: tickets wrap
        (40, 8, 4),  # 4 CTAs > A = 3: one CTA more than sweeps in flight
        (24, 4, 3),  # 3 CTAs = A; every n ends with sweeps of kmax < 2
        (40, 16, 2),  # b = 16 on the instantiation that takes b at run time
    ],
)
def test_bulge_host(host, n, b, ctas, together):
    """The persistent chase against the plain wavefront chase, its CTAs run
    one after another or together (then sweep s waits on sweep s-1's flag);
    twice, bitwise equal: each op is computed by one CTA in a fixed order.
    The second run counts its waits (kernel B's stats): every chase op
    once, and the same bits as the first."""
    host[7](int(not together))
    try:
        B = _band(n, b, n)
        stats = torch.zeros(3, dtype=torch.int64)
        T, log = _chase(host, B, b, ctas)
        T2, log2 = _chase(host, B, b, ctas, stats=stats)
        T3 = _chase(host, B, b, ctas, with_log=False)[0]
    finally:
        host[7](0)
    wait, op, ops = stats.tolist()
    assert ops == sum((n - 3 - s) // b + 1 for s in range(n - 2)) and wait > 0 and op > 0
    assert torch.equal(T, T2) and torch.equal(T, T3)
    assert all(torch.equal(x, y) for x, y in zip((log.vs, log.taus, log.row0),
                                                 (log2.vs, log2.taus, log2.row0)))
    Tp, lp = chase_wavefront_slices(B, b, True)
    assert _rel(T, Tp) < 3e-4
    assert torch.equal(log.row0, lp.row0)
    active = lp.row0 < n
    assert bool((log.taus[~active] == 0).all())
    assert torch.equal(log.vs[~active], lp.vs[~active])
    vsw, tw = sweep_major_log(log)
    QT = backtransform_wy_xla(T, vsw, tw, b=b)
    assert _rel(backtransform_wy_xla(QT.T.contiguous(), vsw, tw, b=b), B) < 3e-4


def test_bulge_host_wait_counter_on_a_bucket(host):
    """Kernel B's counters on a bucket of 3 bands, its CTAs run together:
    one op a chase op of every matrix, sum over s of (n-3-s)//b + 1 each;
    wait and op cycles (the emulation's clock64() counts ns) above 0; T
    and the log bitwise those of the launch without them."""
    count, n, b, ctas = 3, 12, 4, 2
    B = torch.stack([_band(n, b, n + i) for i in range(count)])
    stats = torch.zeros(3, dtype=torch.int64)
    T0, log0 = _chase(host, B, b, ctas)
    T1, log1 = _chase(host, B, b, ctas, stats=stats)
    wait, op, ops = stats.tolist()
    assert ops == count * sum((n - 3 - s) // b + 1 for s in range(n - 2))
    assert wait > 0 and op > 0
    assert torch.equal(T0, T1)
    assert all(torch.equal(x, y) for x, y in zip((log0.vs, log0.taus, log0.row0), (log1.vs, log1.taus, log1.row0)))


@pytest.mark.parametrize("m,transpose,in_smem", [(33, False, True), (5, True, True), (33, True, False), (7, False, False)])
def test_backtransform_host(host, m, transpose, in_smem):
    n, b = 33, 4
    _, log = chase_wavefront_slices(_band(n, b, 2), b, True)
    vs, taus = sweep_major_log(log)
    X = torch.tensor(np.random.default_rng(m).normal(size=(n, m)).astype(np.float32))
    Y = X.clone()
    S, K, _ = vs.shape
    cw = kc.strip_width(n, m)[0] if in_smem else min(32, m)
    work = torch.empty(host[5](n, S, K, b))
    assert host[2](Y.data_ptr(), n, m, vs.data_ptr(), taus.data_ptr(), S, K, b,
                   int(transpose), cw, int(in_smem), work.data_ptr(), 1, None) == 0
    assert _rel(Y, backtransform_wy_xla(X, vs, taus, b=b, transpose=transpose)) < 1e-5 * 8


@pytest.mark.parametrize(
    "n,b,m,transpose,in_smem",
    [
        (33, 4, 5, True, True),    # S = 31: the last group has 7 sweeps
        (33, 4, 9, False, True),
        (23, 2, 6, True, True),    # g = 8 > b + 1: a block's sweeps overlap two rows down
        (23, 2, 6, False, False),
        (40, 3, 11, True, True),   # b = 3 on the 4-wide instantiation
        (40, 5, 4, False, True),   # b = 5 on the 8-wide one
        (50, 8, 13, True, False),  # strip in global memory
        (50, 8, 13, False, True),
        (41, 16, 3, True, True),   # b > g: one block spans 23 rows
        (41, 16, 3, False, True),
        (12, 4, 2, True, True),    # S = 10 < 2g, K = 3
    ],
)
def test_backtransform_host_block_order(host, n, b, m, transpose, in_smem):
    """The sweep-blocked walk at shapes where its ordering is easy to get
    wrong: a last group of fewer than g sweeps, g > b + 1, b > g, last
    sweeps with fewer than b rows, both directions."""
    _, log = chase_wavefront_slices(_band(n, b, n + b), b, True)
    vs, taus = sweep_major_log(log)
    X = torch.tensor(np.random.default_rng(n * m).normal(size=(n, m)).astype(np.float32))
    Y = X.clone()
    S, K, _ = vs.shape
    cw = kc.strip_width(n, m)[0] if in_smem else min(32, m)
    work = torch.empty(host[5](n, S, K, b))
    assert host[2](Y.data_ptr(), n, m, vs.data_ptr(), taus.data_ptr(), S, K, b,
                   int(transpose), cw, int(in_smem), work.data_ptr(), 1, None) == 0
    assert _rel(Y, backtransform_wy_xla(X, vs, taus, b=b, transpose=transpose)) < 1e-5 * 8


@pytest.mark.parametrize(
    "n,k,alpha,c_view",
    [(70, 37, -1.0, True), (64, 16, 1.0, None), (5, 3, 0.5, False), (129, 20, -1.0, True), (17, 0, 1.0, False)],
)
def test_syr2k_host(host, n, k, alpha, c_view):
    """Odd n, k off the 16-wide strip, C absent (None) or a strided view."""
    rng = np.random.default_rng(n + k)
    A = torch.tensor(rng.normal(size=(n, k)).astype(np.float32))
    B = torch.tensor(rng.normal(size=(n, k)).astype(np.float32))
    C = None if c_view is None else _sym(n + 3, n)[3:, 3:] if c_view else _sym(n, n)
    out = torch.full((n, n), float("nan"))
    assert host[3](A.data_ptr(), B.data_ptr(), k, 0, n, k, alpha,
                   None if C is None else C.data_ptr(), 0 if C is None else C.stride(0), 0,
                   out.data_ptr(), 0, 1, None) == 0
    want = ref.syr2k_ref(A, B, C, alpha=alpha)
    assert torch.equal(out, out.T)
    assert float((out - want).abs().max()) <= 2e-5 * max(float(want.abs().max()), 1.0)


@pytest.mark.parametrize("n,c_view", [(96, True), (130, None)])
def test_syr2k_host_3xtf32_accuracy(host, n, c_view):
    """float32 kernel D on the (emulated) tensor cores keeps float32
    accuracy at k = 256: within 2e-6 max|ref| of a float64 reference, which
    a one-pass TF32 product (the small terms dropped: ~4e-4 here) misses,
    and so does a walk that chains all of k through the tensor cores' sums,
    which round toward zero (~5e-6)."""
    k = 256
    rng = np.random.default_rng(n * k)
    A = torch.tensor(rng.normal(size=(n, k)).astype(np.float32))
    B = torch.tensor(rng.normal(size=(n, k)).astype(np.float32))
    C = None if c_view is None else _sym(n + 3, n)[3:, 3:]
    out = torch.full((n, n), float("nan"))
    assert host[3](A.data_ptr(), B.data_ptr(), k, 0, n, k, -1.0, None if C is None else C.data_ptr(),
                   0 if C is None else C.stride(0), 0, out.data_ptr(), 0, 1, None) == 0
    Ad, Bd = A.double(), B.double()
    want = -(Ad @ Bd.T + Bd @ Ad.T)
    if C is not None:
        want += torch.tril(C.double()) + torch.tril(C.double(), -1).T
    assert torch.equal(out, out.T)
    assert float((out.double() - want).abs().max()) <= 2e-6 * float(want.abs().max())


@pytest.mark.parametrize(
    "n,k,c_view",
    [
        (70, 37, True),     # k off the 8-wide copies: element-wise staging
        (64, 16, None),     # one strip, its second half zero-filled
        (5, 3, False),
        (129, 37, None),    # ragged n over three tile rows, C absent
        (129, 37, True),    # ... with C a strided view (element-wise C loads)
        (136, 72, False),   # n, k multiples of 8: 16-byte copies, loads and stores
    ],
)
def test_syr2k_host_bf16(host, n, k, c_view):
    """bf16 operands: products on the (emulated) tensor cores, summed in
    float32, rounded once; held against the float32 plain version of the
    same (bf16-valued) inputs to one bf16 rounding of the result, and to
    exact symmetry."""
    rng = np.random.default_rng(n * k)
    A = torch.tensor(rng.normal(size=(n, k)).astype(np.float32)).to(torch.bfloat16)
    B = torch.tensor(rng.normal(size=(n, k)).astype(np.float32)).to(torch.bfloat16)
    C = None if c_view is None else _sym(n + 3, n)[3:, 3:] if c_view else _sym(n, n)
    C = None if C is None else C.to(torch.bfloat16)
    out = torch.zeros((n, n), dtype=torch.bfloat16)
    assert host[3](A.data_ptr(), B.data_ptr(), k, 0, n, k, -1.0,
                   None if C is None else C.data_ptr(), 0 if C is None else C.stride(0), 0,
                   out.data_ptr(), 1, 1, None) == 0
    want = ref.syr2k_ref(A.float(), B.float(), None if C is None else C.float(), alpha=-1.0)
    assert torch.equal(out, out.T)
    assert float((out.float() - want).abs().max()) <= 2 ** -8 * float(want.abs().max())


def test_mma_bf16_16816_host(host):
    """repro::mma_bf16_16816 alone: a 16 x 16 by 16 x 8 bf16 product through
    the PTX fragment layout against a float matmul of the same values."""
    rng = np.random.default_rng(16816)
    A = torch.tensor(rng.normal(size=(16, 16)).astype(np.float32)).to(torch.bfloat16)
    B = torch.tensor(rng.normal(size=(16, 8)).astype(np.float32)).to(torch.bfloat16)
    D = torch.full((16, 8), float("nan"))
    assert host[8](A.data_ptr(), B.data_ptr(), D.data_ptr()) == 0
    want = A.double() @ B.double()
    assert float((D.double() - want).abs().max()) <= 1e-6 * float(want.abs().max())


def _tf32_round(x: np.ndarray) -> np.ndarray:
    """float32 to TF32 bits: nearest, ties away from zero, 10 mantissa bits."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & ~np.uint64(0x1FFF)).astype(np.uint32)


def test_mma_tf32_1688_host(host):
    """repro::to_tf32 and repro::mma_tf32_1688 alone: the rounding of A
    (with ties and a carry into the exponent) against numpy's, and a
    16 x 8 by 8 x 8 TF32 product through the PTX fragment layout against a
    float64 matmul of the rounded values."""
    rng = np.random.default_rng(1688)
    a = rng.normal(size=(16, 8)).astype(np.float32)
    bits = a.view(np.uint32)
    bits[0, :4] = (bits[0, :4] & ~np.uint32(0x1FFF)) | np.uint32(0x1000)  # ties: away from zero
    bits[1, 0] = 0x3F7FFFFF  # just below 1.0: the carry reaches the exponent
    bits[1, 1] = 0xBF7FF000  # a negative tie
    b = rng.normal(size=(8, 8)).astype(np.float32)
    A, B = torch.tensor(a), torch.tensor(b)
    D = torch.full((16, 8), float("nan"))
    RA = torch.zeros((16, 8), dtype=torch.int32)
    assert host[9](A.data_ptr(), B.data_ptr(), D.data_ptr(), RA.data_ptr()) == 0
    ra = RA.numpy().view(np.uint32)
    assert np.array_equal(ra, _tf32_round(a))
    assert ra[1, 0] == 0x3F800000 and ra[1, 1] == 0xBF800000
    want = ra.view(np.float32).astype(np.float64) @ _tf32_round(b).view(np.float32).astype(np.float64)
    assert float(np.abs(D.double().numpy() - want).max()) <= 1e-6 * float(np.abs(want).max())


@pytest.mark.parametrize("cluster", [1, 2, 3, 12, 16])
@pytest.mark.parametrize(
    "m,b,smem",
    [
        (33, 8, SMEM),
        (17, 5, SMEM),   # b = 5 on the 8-wide instantiation; at 16 CTAs, 7 hold no rows
        (40, 8, 1024),   # one CTA's slice above the budget: global workspace
        (64, 16, SMEM),
        (8, 8, 0),       # every slice in the global workspace
        (24, 8, SMEM),   # at 16 CTAs every pivot row starts a CTA's slice
        (70, 8, 0),      # global workspace across the cluster
        (40, 32, SMEM),  # b = 32: 496 larft pairs on blocks of 32-64 threads
    ],
)
def test_panel_qr_host(host, m, b, smem, cluster):
    """Kernel E against panel_qr_body(lapack_sign=False) on clusters of 1, 2,
    3, 12 and 16 CTAs: uneven and empty slices, pivot rows on CTA
    boundaries, a degenerate column, slices in shared memory or, below the
    budget, in the global workspace."""
    P = torch.tensor(np.random.default_rng(m * b).normal(size=(m, b)).astype(np.float32))
    P[6:, 2] = 0.0  # a degenerate column: sigma == 0 -> tau == 0
    V, T, taus, R = torch.empty(m, b), torch.empty(b, b), torch.empty(b), torch.empty(b, b)
    work = torch.full((m + cluster, b), float("nan"))
    assert host[4](P.data_ptr(), m, b, V.data_ptr(), T.data_ptr(), taus.data_ptr(),
                   R.data_ptr(), work.data_ptr(), smem, cluster, None) == 0
    for got, want in zip((V, T, taus, R), ke.panel_qr_body(P, b, lapack_sign=False)):
        assert float((got - want).abs().max()) <= 5e-5 * max(float(want.abs().max()), 1.0)


@pytest.mark.parametrize(
    "m,b,smem,cluster,in_smem",
    [(33, 8, SMEM, 2, True), (1500, 8, SMEM, 12, True), (40, 8, 1024, 1, False), (300, 16, 0, 3, False)],
)
def test_panel_qr_host_plan_and_workspace(host, m, b, smem, cluster, in_smem):
    """panel_qr_plan says whether the slices fit shared memory; the launch
    then takes no workspace (null), and refuses a null one where they do
    not fit."""
    fe, plan = host[4], host[10]
    got_in_smem = ctypes.c_int(-1)
    assert plan(m, b, smem, cluster, ctypes.byref(got_in_smem)) == cluster
    assert bool(got_in_smem.value) == in_smem
    P = torch.tensor(np.random.default_rng(m + b).normal(size=(m, b)).astype(np.float32))
    V, T, taus, R = torch.empty(m, b), torch.empty(b, b), torch.empty(b), torch.empty(b, b)
    rc = fe(P.data_ptr(), m, b, V.data_ptr(), T.data_ptr(), taus.data_ptr(), R.data_ptr(), None,
            smem, cluster, None)
    if not in_smem:
        assert rc != 0
        return
    assert rc == 0
    for got, want in zip((V, T, taus, R), ke.panel_qr_body(P, b, lapack_sign=False)):
        assert float((got - want).abs().max()) <= 5e-5 * max(float(want.abs().max()), 1.0)


def test_panel_qr_cluster_size_rule():
    """Kernel E's cluster grows with the panel up to PANEL_QR_CLUSTER: the
    n = 4096 path's first panels take 16 CTAs, its last ones one."""
    assert ke.cluster_size(4088) == ke.cluster_size(8192) == limit("PANEL_QR_CLUSTER") == 16
    assert ke.cluster_size(8) == ke.cluster_size(ke._ROWS_PER_CTA) == 1
    assert ke.cluster_size(ke._ROWS_PER_CTA + 1) == 2
    assert all(ke.cluster_size(m) <= ke.cluster_size(m + 1) for m in range(1, 5000, 7))
