"""The hand-written Hopper kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one (the decision is
made in the ``cuda_device`` fixture, never at import).  Run them on the
H100 with:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Inputs are made with numpy from a seed; both versions see the same tensor
on the card.  TF32 is off, so the plain versions' matmuls are full fp32.
Tolerances are relative to the largest entry of the reference: the kernels
sum in other orders than cuBLAS / the plain loops, so agreement is at fp32
rounding grown by the reduction length, not bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.backtransform import backtransform_wy_xla, sweep_major_log  # noqa: E402
from repro_torch.core.band_reduction import band_reduce, build_stage_schedule  # noqa: E402
from repro_torch.core.bulge_chasing import chase_wavefront_slices  # noqa: E402
from repro_torch.kernels import cuda_lib, limits, ops, ref  # noqa: E402
from repro_torch.kernels import panel as ke  # noqa: E402
from repro_torch.kernels.panel import panel_qr_body  # noqa: E402
from repro_torch.solver import EvdConfig, by_count, plan  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run with `python -m pytest -m cuda` on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _sym(n, seed):
    a = np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
    return a + a.T


def _rel(x, y):
    x, y = x.double().cpu(), y.double().cpu()
    return float((x - y).abs().max() / max(float(y.abs().max()), 1.0))


def _band(n, b, seed, device):
    """A random symmetric band matrix of bandwidth b, dense storage."""
    a = _sym(n, seed)
    i = np.arange(n)
    a[np.abs(i[:, None] - i[None, :]) > b] = 0.0
    return torch.as_tensor(a, device=device)


@pytest.mark.parametrize(
    "m,w,b,qr_smem",
    [
        (48, 16, 8, None),
        (40, 32, 8, None),      # ragged: w = m - b
        (64, 32, 4, None),
        (96, 48, 16, None),
        (72, 32, 8, 0),         # panel QR in global memory
        (1024, 128, 8, None),
        (4096, 256, 8, None),   # first block of the n = 4096 main path
    ],
)
def test_fused_panel_update_matches_plain(cuda_device, monkeypatch, m, w, b, qr_smem):
    if qr_smem is not None:
        monkeypatch.setitem(limits.LIMITS, "PANEL_QR_SMEM", qr_smem)
    A = torch.as_tensor(_sym(m, m), device=cuda_device)
    Bk, Vk, Tk = ops.fused_panel_update(A.clone(), b, w)
    Bp, Vp, Tp = ref.fused_panel_update_ref(A.clone(), b, w)
    torch.cuda.synchronize()
    tol = 1e-5 * max(8.0, m ** 0.5)
    assert _rel(Bk, Bp) < tol
    assert _rel(Vk, Vp) < tol
    assert _rel(Tk, Tp) < tol
    # exact zeros above the band in the factored columns
    rows = torch.arange(m, device=cuda_device)[:, None]
    cols = torch.arange(w, device=cuda_device)[None, :]
    assert (Bk[:, :w][rows < cols - b] == 0).all()


@pytest.mark.parametrize(
    "m,w,b,cluster",
    [
        (1024, 128, 8, 16),   # the non-portable cluster size (or its fallback, 8)
        (1024, 128, 8, 8),
        (1000, 64, 8, 3),     # slices of 331 / 330 rows, not a multiple of the cluster
        (520, 256, 8, 5),
        (264, 256, 8, 4),     # the last DBR blocks of the n = 4096 path
        (264, 256, 8, 1),
        (300, 96, 16, 7),
    ],
)
def test_fused_panel_update_cluster_splits(cuda_device, monkeypatch, m, w, b, cluster):
    """The panel QR's rows split over clusters of 1-16 CTAs."""
    monkeypatch.setitem(limits.LIMITS, "PANEL_QR_CLUSTER", cluster)
    A = torch.as_tensor(_sym(m, m + cluster), device=cuda_device)
    Bk, Vk, Tk = ops.fused_panel_update(A.clone(), b, w)
    Bp, Vp, Tp = ref.fused_panel_update_ref(A.clone(), b, w)
    torch.cuda.synchronize()
    tol = 1e-5 * max(8.0, m ** 0.5)
    assert _rel(Bk, Bp) < tol and _rel(Vk, Vp) < tol and _rel(Tk, Tp) < tol


def test_fused_panel_update_in_place_on_a_strided_view(cuda_device):
    n, ci, b, w = 96, 32, 8, 32
    A = torch.as_tensor(_sym(n, 3), device=cuda_device)
    B1, B2 = A.clone(), A.clone()
    ops.fused_panel_update(B1[ci:, ci:], b, w)
    ref.fused_panel_update_ref(B2[ci:, ci:], b, w)
    assert _rel(B1, B2) < 1e-4
    assert torch.equal(B1[:ci], A[:ci]) and torch.equal(B1[:, :ci], A[:, :ci])


@pytest.mark.parametrize("m,w,b", [(4096, 256, 8), (128, 64, 8), (300, 48, 16)])
def test_fused_panel_update_bitwise_repeatable(cuda_device, m, w, b):
    """Kernel A sums its reductions in a fixed order (no float atomics), so
    two calls on one input give the same bits."""
    A = torch.as_tensor(_sym(m, 7), device=cuda_device)
    runs = [ops.fused_panel_update(A.clone(), b, w) for _ in range(2)]
    torch.cuda.synchronize()
    for x, y in zip(*runs):
        assert torch.equal(x, y)


def test_plan_bitwise_repeatable(cuda_device):
    """plan(128) (Shampoo's block size and blocking) twice on one matrix:
    the same eigenvalues and eigenvectors, bit for bit."""
    A = torch.as_tensor(_sym(128, 8), device=cuda_device)
    pl = plan(128, torch.float32, EvdConfig(b=8, nb=64))
    (w1, V1), (w2, V2) = pl(A), pl(A)
    assert torch.equal(w1, w2) and torch.equal(V1, V2)


def _reflectors(log, active):
    v, t = log.vs[active], log.taus[active]
    return t[:, None, None] * v[:, :, None] * v[:, None, :]


@pytest.mark.parametrize("n,b", [(16, 4), (48, 8), (50, 4), (130, 16), (1024, 8)])
@pytest.mark.parametrize("with_log", [False, True])
def test_bulge_wavefront_matches_plain(cuda_device, n, b, with_log):
    B = _band(n, b, n, cuda_device)
    out_k = ops.bulge_wavefront(B, b, return_log=with_log)
    out_p = chase_wavefront_slices(B, b, with_log)
    torch.cuda.synchronize()
    if not with_log:
        assert torch.equal(out_k, ops.bulge_wavefront(B, b, return_log=True)[0])
        out_k, out_p = (out_k, None), (out_p, None)
    (Tk, lk), (Tp, lp) = out_k, out_p
    # Entrywise only at the small sizes; at every size T must be exactly
    # tridiagonal and have the plain T's spectrum.
    i = torch.arange(n, device=cuda_device)
    assert (Tk[(i[:, None] - i[None, :]).abs() > 1] == 0).all()
    assert _rel(torch.linalg.eigvalsh(Tk.double()), torch.linalg.eigvalsh(Tp.double())) < 3e-4
    if n <= 130:
        assert _rel(Tk, Tp) < 3e-4
    if not with_log:
        return
    assert lk.vs.shape == lp.vs.shape and lk.taus.shape == lp.taus.shape
    assert torch.equal(lk.row0, lp.row0)
    active = lp.row0 < n
    # The kernel's log must reproduce B = Q2 T Q2^T (applied with the plain
    # back-transform).  Entrywise, a reflector is only determined up to
    # rounding amplified by 1/|x| where its column x is already tiny, so the
    # tau v v^T comparison is held only at n <= 64 (measured on the H100:
    # 5.4e-4 at n = 130, 0.97 at n = 4096, while Q2 T Q2^T matched B to
    # 3.6e-6 at n = 4096).
    vs, taus = sweep_major_log(lk)
    QT = backtransform_wy_xla(Tk, vs, taus, b=b)
    assert _rel(backtransform_wy_xla(QT.T.contiguous(), vs, taus, b=b), B) < 3e-4
    if n <= 64:
        assert _rel(_reflectors(lk, active), _reflectors(lp, active)) < 3e-4
    assert torch.equal(lk.taus[~active], lp.taus[~active])
    assert torch.equal(lk.vs[~active], lp.vs[~active])


@pytest.mark.parametrize("n,b", [(1024, 8), (1030, 16), (4096, 8)])
def test_bulge_wavefront_repeatable(cuda_device, n, b):
    """Two calls give bitwise the same T and log: each op is computed by one
    CTA in a fixed order, whichever CTA takes its sweep (the CTAs take far
    more sweeps than there are CTAs, so tickets wrap)."""
    B = _band(n, b, n + 7, cuda_device)
    T1, l1 = ops.bulge_wavefront(B, b, return_log=True)
    T2, l2 = ops.bulge_wavefront(B, b, return_log=True)
    T3 = ops.bulge_wavefront(B, b)
    torch.cuda.synchronize()
    assert torch.equal(T1, T2) and torch.equal(T1, T3)
    assert torch.equal(l1.vs, l2.vs) and torch.equal(l1.taus, l2.taus) and torch.equal(l1.row0, l2.row0)


@pytest.mark.parametrize("with_log", [False, True])
def test_bulge_wavefront_is_one_launch(cuda_device, with_log):
    """One call of kernel B is one CUDA launch of the persistent kernel, as
    its launcher counts (the profiler sees the kernel once)."""
    from torch.profiler import ProfilerActivity, profile

    n, b = 512, 8
    B = _band(n, b, 5, cuda_device)
    ops.bulge_wavefront(B, b, return_log=with_log)  # build and warm up
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ops.bulge_wavefront(B, b, return_log=with_log)
        torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["bulge_wavefront"] == 1
    assert cuda_lib.device_launch_counts()["bulge_wavefront"] == 1
    chase = [ev for ev in prof.key_averages() if "bulge_chase_kernel" in ev.key
             and (getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)) > 0]
    assert sum(ev.count for ev in chase) == 1, [(ev.key, ev.count) for ev in chase]


@pytest.mark.parametrize("n,m,b", [(48, 48, 8), (64, 8, 8), (50, 17, 4), (1024, 1024, 8), (4096, 64, 8)])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("smem", [None, 0])
def test_backtransform_wy_matches_plain(cuda_device, monkeypatch, n, m, b, transpose, smem):
    if smem is not None:
        monkeypatch.setitem(limits.LIMITS, "BACKTRANSFORM_SMEM", smem)
    from repro_torch.core.bulge_chasing import band_to_tridiag

    B = _band(n, b, n + 1, cuda_device)
    _, log = band_to_tridiag(B, b, return_log=True, backend="torch")
    vs, taus = sweep_major_log(log)
    X = torch.as_tensor(np.random.default_rng(n).normal(size=(n, m)).astype(np.float32), device=cuda_device)
    Yk = ops.backtransform_wy(X, vs, taus, b=b, transpose=transpose)
    Yp = backtransform_wy_xla(X, vs, taus, b=b, transpose=transpose)
    torch.cuda.synchronize()
    assert _rel(Yk, Yp) < 1e-5 * max(8.0, n ** 0.5)


@pytest.mark.parametrize(
    "n,b,m",
    [(33, 4, 5), (23, 2, 6), (41, 16, 3), (40, 3, 11), (12, 4, 2), (4096, 8, 7), (1030, 8, 300)],
)
@pytest.mark.parametrize("transpose", [False, True])
def test_backtransform_wy_block_order(cuda_device, n, b, m, transpose):
    """The sweep-blocked walk where its ordering is easy to get wrong: a
    last group of fewer than 8 sweeps, groups longer than b + 1, b longer
    than a group, last sweeps with fewer than b rows."""
    B = _band(n, b, n + b, cuda_device)
    _, log = ops.bulge_wavefront(B, b, return_log=True)
    vs, taus = sweep_major_log(log)
    X = torch.as_tensor(np.random.default_rng(n * m).normal(size=(n, m)).astype(np.float32), device=cuda_device)
    Yk = ops.backtransform_wy(X, vs, taus, b=b, transpose=transpose)
    Yp = backtransform_wy_xla(X, vs, taus, b=b, transpose=transpose)
    torch.cuda.synchronize()
    assert _rel(Yk, Yp) < 1e-5 * max(8.0, n ** 0.5)


@pytest.mark.parametrize(
    "n,k,c_view", [(64, 16, False), (100, 37, True), (8, 248, True), (1, 3, False), (3840, 256, True)]
)
def test_syr2k_matches_plain(cuda_device, n, k, c_view):
    rng = np.random.default_rng(n + k)
    a = torch.as_tensor(rng.normal(size=(n, k)).astype(np.float32), device=cuda_device)
    b = torch.as_tensor(rng.normal(size=(n, k)).astype(np.float32), device=cuda_device)
    c = torch.as_tensor(_sym(n + 2, n), device=cuda_device)
    C = c[2:, 2:] if c_view else c[:n, :n].contiguous()
    for got, want in (
        (ops.trailing_update(C, b, a), ref.syr2k_ref(a, b, C, alpha=-1.0)),
        (ops.syr2k(a, b, alpha=0.5), ref.syr2k_ref(a, b, alpha=0.5)),
    ):
        torch.cuda.synchronize()
        assert torch.equal(got, got.T)
        assert float((got - want).abs().max()) <= 2e-5 * max(float(want.abs().max()), 1.0)


@pytest.mark.parametrize("n,k,c_view", [(3840, 256, True), (3840, 256, None), (130, 256, True)])
def test_syr2k_fp32_keeps_fp32_accuracy(cuda_device, n, k, c_view):
    """float32 kernel D on the tensor cores (3xTF32) within 2e-6 max|ref| of
    a float64 reference at k = 256 (a one-pass TF32 product is ~4e-4
    off)."""
    rng = np.random.default_rng(n * k + 1)
    a = torch.as_tensor(rng.normal(size=(n, k)).astype(np.float32), device=cuda_device)
    b = torch.as_tensor(rng.normal(size=(n, k)).astype(np.float32), device=cuda_device)
    ad, bd = a.double(), b.double()
    want = -(ad @ bd.T + bd @ ad.T)
    if c_view is None:
        got = ops.syr2k(a, b, alpha=-1.0)
    else:
        C = torch.as_tensor(_sym(n + 2, n), device=cuda_device)[2:, 2:]
        got = ops.trailing_update(C, b, a)
        want += torch.tril(C.double()) + torch.tril(C.double(), -1).T
    torch.cuda.synchronize()
    assert torch.equal(got, got.T)
    assert float((got.double() - want).abs().max()) <= 2e-6 * float(want.abs().max())


@pytest.mark.parametrize(
    "n,k,c_view",
    [(64, 16, False), (100, 37, True), (3840, 256, True), (129, 37, None), (3840, 256, None)],
)
def test_syr2k_bf16_matches_plain(cuda_device, n, k, c_view):
    """bf16 operands against the float32 plain version of the same
    (bf16-valued) inputs at tests/test_kernels.py's bf16 tolerance; C a
    view, contiguous, or absent (None)."""
    rng = np.random.default_rng(n * k)
    bf = torch.bfloat16
    a = torch.as_tensor(rng.normal(size=(n, k)).astype(np.float32), device=cuda_device).to(bf)
    b = torch.as_tensor(rng.normal(size=(n, k)).astype(np.float32), device=cuda_device).to(bf)
    if c_view is None:
        got = ops.syr2k(a, b, alpha=-1.0)
        want = ref.syr2k_ref(a.float(), b.float(), alpha=-1.0)
    else:
        c = torch.as_tensor(_sym(n + 2, n), device=cuda_device).to(bf)
        C = c[2:, 2:] if c_view else c[:n, :n].contiguous()
        got = ops.trailing_update(C, b, a)
        want = ref.syr2k_ref(a.float(), b.float(), C.float(), alpha=-1.0)
    torch.cuda.synchronize()
    assert got.dtype == bf and torch.equal(got, got.T)
    assert float((got.float() - want).abs().max()) <= 5e-2 * float(want.abs().max())


@pytest.mark.parametrize("cluster", [1, 2, 3, 12, 16])
@pytest.mark.parametrize(
    "m,b,smem,degenerate",
    [
        (4088, 8, None, False),
        (8192, 8, None, False),
        (17, 5, None, False),   # at 16 CTAs, 7 hold no rows
        (300, 16, 0, False),    # slices in the global workspace
        (64, 32, None, False),
        (24, 8, None, True),    # at 16 CTAs every pivot row starts a slice
        (4088, 8, 0, True),     # global workspace at the path's largest panel
    ],
)
def test_panel_qr_matches_plain(cuda_device, monkeypatch, m, b, smem, degenerate, cluster):
    """Kernel E on clusters of 1, 2, 3, 12 and 16 CTAs (8 where the card
    cannot co-schedule 12 or 16) against panel_qr_body(lapack_sign=False)."""
    if smem is not None:
        monkeypatch.setitem(limits.LIMITS, "PANEL_QR_SMEM", smem)
    P = torch.as_tensor(np.random.default_rng(m).normal(size=(m, b)).astype(np.float32), device=cuda_device)
    if degenerate:
        P[6:, 2] = 0.0  # sigma == 0 -> tau == 0
    got = ke.panel_qr_cuda_cluster(P, cluster)
    want = panel_qr_body(P, b, lapack_sign=False)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 5e-5 * max(float(w.abs().max()), 1.0)


@pytest.mark.parametrize("smem", [None, 0])
@pytest.mark.parametrize("m", [4088, 1500, 300, 8])
def test_panel_qr_op_uses_the_cluster_rule(cuda_device, monkeypatch, m, smem):
    """ops.panel_qr runs kernel E once, on cluster_size(m) CTAs (16, 12, 3
    and 1 here), and agrees with panel_qr_body(lapack_sign=False); bitwise
    what an explicit launch of that size gives."""
    if smem is not None:
        monkeypatch.setitem(limits.LIMITS, "PANEL_QR_SMEM", smem)
    P = torch.as_tensor(np.random.default_rng(m + 1).normal(size=(m, 8)).astype(np.float32), device=cuda_device)
    P[6:, 2] = 0.0  # sigma == 0 -> tau == 0
    cuda_lib.reset_launch_counts()
    got = ops.panel_qr(P)
    assert cuda_lib.launch_counts()["panel_qr"] == 1 and cuda_lib.device_launch_counts()["panel_qr"] == 1
    assert ke.cluster_size(m) == {4088: 16, 1500: 12, 300: 3, 8: 1}[m]
    want = panel_qr_body(P, 8, lapack_sign=False)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 5e-5 * max(float(w.abs().max()), 1.0)
    again = ke.panel_qr_cuda_cluster(P, ke.cluster_size(m))
    assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_band_reduce_kernel_panels_on_card(cuda_device):
    n, b, nb = 512, 8, 64
    A = torch.as_tensor(_sym(n, 12), device=cuda_device)
    cuda_lib.reset_launch_counts()
    B = band_reduce(A, b, nb, panel_method="kernel")
    counts = cuda_lib.launch_counts()
    schedule = build_stage_schedule(n, b, nb)
    assert counts["panel_qr"] == schedule.num_panels
    assert counts["trailing_update"] == len(schedule.entries)
    w_ref = torch.linalg.eigvalsh(A.double())
    err = float((torch.linalg.eigvalsh(B.double()) - w_ref).abs().max())
    assert err < 3e-4 * float(w_ref.abs().max())


def test_kernels_raise_on_cpu_tensors():
    from repro_torch.kernels.backtransform import backtransform_wy_cuda
    from repro_torch.kernels.bulge import bulge_wavefront_cuda
    from repro_torch.kernels.fused_panel import fused_panel_update_cuda
    from repro_torch.kernels.panel import panel_qr_cuda
    from repro_torch.kernels.syr2k import syr2k_cuda, trailing_update_cuda

    A = torch.zeros((16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fused_panel_update_cuda(A, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        bulge_wavefront_cuda(A, 4)
    with pytest.raises(ValueError, match="CUDA"):
        backtransform_wy_cuda(A, torch.zeros((14, 4, 4)), torch.zeros((14, 4)), b=4)
    with pytest.raises(ValueError, match="CUDA"):
        syr2k_cuda(A[:, :4], A[:, :4])
    with pytest.raises(ValueError, match="CUDA"):
        trailing_update_cuda(A, A[:, :4], A[:, :4])
    with pytest.raises(ValueError, match="CUDA"):
        panel_qr_cuda(A[:, :4])


@pytest.mark.parametrize(
    "cfg,ops_run",
    [
        (EvdConfig(), ("fused_panel_update", "bulge_wavefront", "backtransform_wy")),
        (EvdConfig(spectrum=by_count(8)), ("fused_panel_update", "bulge_wavefront", "backtransform_wy")),
        # unfused: the chase with a log is plain tensor code (chase_wavefront)
        (EvdConfig(tridiag="unfused"), ("trailing_update", "backtransform_wy")),
    ],
)
def test_plan_on_card_uses_every_kernel(cuda_device, cfg, ops_run):
    n = 512
    A = torch.as_tensor(_sym(n, 11), device=cuda_device)
    cuda_lib.reset_launch_counts()
    w, V = plan(n, torch.float32, cfg)(A)
    counts = cuda_lib.launch_counts()
    assert {op for op, c in counts.items() if c > 0} == set(ops_run), counts
    w_ref = torch.linalg.eigvalsh(A.double())
    start, count = cfg.spectrum.index_range(n)
    scale = float(w_ref.abs().max())
    assert float((w.double() - w_ref[start : start + count]).abs().max()) < 3e-4 * scale
    resid = A.double() @ V.double() - V.double() * w.double()[None, :]
    assert float(resid.abs().max()) < 5e-4 * scale
    assert float((V.double().T @ V.double() - torch.eye(count, dtype=torch.float64, device=cuda_device)).abs().max()) < 2e-4


@pytest.mark.parametrize("tridiag", ["fused", "unfused"])
def test_solve_many_on_card_matches_plan_loop(cuda_device, tridiag):
    """A 16 x 128 stack through solve_many against plan(128) one matrix at a
    time on the card: the bucket launches each kernel 16 x one solve's
    calls; eigenvalues agree at 1e-5 max|w| and sign-aligned eigenvector
    columns at 1e-4."""
    from repro_torch.solver import solve_many

    n, B = 128, 16
    cfg = EvdConfig(b=8, nb=64, tridiag=tridiag)
    stack = torch.as_tensor(np.stack([_sym(n, 300 + i) for i in range(B)]), device=cuda_device)
    pl = plan(n, torch.float32, cfg)
    cuda_lib.reset_launch_counts()
    pl(stack[0])
    one = {op: c for op, c in cuda_lib.launch_counts().items() if c}
    one_dev = {op: c for op, c in cuda_lib.device_launch_counts().items() if c}
    cuda_lib.reset_launch_counts()
    w, V = solve_many(stack, cfg)
    assert {op: c for op, c in cuda_lib.launch_counts().items() if c} == {op: B * c for op, c in one.items()}
    assert {op: c for op, c in cuda_lib.device_launch_counts().items() if c} == {
        op: B * c for op, c in one_dev.items()
    }
    assert "backtransform_wy" in one and ("fused_panel_update" in one) == (tridiag == "fused")
    for i in range(B):
        wi, Vi = pl(stack[i])
        assert float((w[i] - wi).abs().max()) < 1e-5 * float(wi.abs().max())
        s = torch.sign((V[i] * Vi).sum(0))
        assert float((V[i] * s[None, :] - Vi).abs().max()) < 1e-4


def test_rank_deficient_bucket_roots_on_card(cuda_device):
    """Shampoo statistics blocks of rank 4 in 128 (a (4, 32) leaf's
    gradient padded to a block) give inverse iteration exactly repeated
    lanes; CUDA's batched QR returned a non-orthogonal Q for them, so the
    bucket's roots were off by up to 1e2 while ``plan(128)`` one matrix at
    a time was right.  The bucket's roots, beside full-rank blocks, within
    1e-5 of the float64 formula, and its eigenvectors orthogonal."""
    from repro_torch.solver import solve_many

    rng = np.random.default_rng(11)
    g = np.zeros((6, 128, 128), np.float32)
    g[:3, :4, :32] = rng.normal(size=(3, 4, 32))
    g[3:] = rng.normal(size=(3, 128, 128))
    G = torch.as_tensor(g, device=cuda_device) * 1e-4
    S = 0.01 * G @ G.mT
    S = 0.5 * (S + S.mT)  # the operand the solver takes (it symmetrizes)
    pre = solve_many(S, EvdConfig(b=8, nb=64), op="inverse_pth_root", p=4, eps=1e-6)
    w, V = torch.linalg.eigh(S.double())
    ridge = 1e-6 * w.amax(-1, keepdim=True)
    X = (V * (w.clamp(min=0) + ridge).pow(-0.25)[:, None, :]) @ V.mT
    err = (pre.double() - X).abs().amax((-2, -1)) / X.abs().amax((-2, -1))
    assert float(err.max()) < 1e-5, err
    _, Vb = solve_many(S, EvdConfig(b=8, nb=64), op="eigh")
    orth = (Vb.mT @ Vb - torch.eye(128, device=cuda_device)).abs().amax((-2, -1))
    assert float(orth.max()) < 1e-4, orth
