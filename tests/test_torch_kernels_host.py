"""The CUDA kernels' arithmetic and indexing, run on the CPU by emulation.

Each ``src/repro_torch/csrc/*.cu`` (kernels A to E) is compiled with g++ against
``tests/cuda_host/cuda_runtime.h``, which runs a launch's blocks one after
another with one host thread per CUDA thread.  The exported launchers are
called through ctypes with CPU tensors and held against the plain PyTorch
versions at the tolerances of tests/test_torch_kernels_cuda.py.  Blocks
never overlap here, so races between CTAs are the card's tests' job
(``python -m pytest -m cuda``); skipped where g++ is missing.
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
    for name in ("fused_panel", "bulge", "backtransform", "syr2k", "panel"):
        so = out / f"{name}.so"
        cmd = [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-w",
               f"-I{SHIM}", "-x", "c++", str(CSRC / f"{name}.cu"), "-o", str(so)]
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
    return fa, fb, fc, fd, fe


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


def _fused(fa, Bv, b, w, qr_smem=SMEM):
    """The launcher's buffers (repro_torch.kernels.fused_panel), on the CPU."""
    m = Bv.shape[0]
    q = w // b
    e = torch.empty
    V, Ts, Z, F = e(m, w), e(q, b, b), e(m, w), e(m, w)
    P, Vh, MT, X, Y = e(m, b), e(m, b), e(m, b), e(2 * w * b), e(b * b)
    err = fa(Bv.data_ptr(), Bv.stride(0), m, w, b, V.data_ptr(), Ts.data_ptr(), Z.data_ptr(),
             F.data_ptr(), P.data_ptr(), Vh.data_ptr(), MT.data_ptr(), X.data_ptr(), Y.data_ptr(),
             qr_smem, None)
    assert err == 0
    return Bv, V, Ts


@pytest.mark.parametrize(
    "m,w,b,qr_smem",
    [(48, 16, 8, SMEM), (40, 32, 8, SMEM), (36, 12, 4, SMEM), (72, 32, 8, 0), (48, 32, 16, SMEM)],
)
def test_fused_panel_host(host, m, w, b, qr_smem):
    A = _sym(m, m)
    Bk, Vk, Tk = _fused(host[0], A.clone(), b, w, qr_smem)
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


@pytest.mark.parametrize("n,b,group", [(16, 4, 1), (33, 4, 1), (40, 8, 2), (24, 4, 3)])
def test_bulge_host(host, n, b, group):
    B = _band(n, b, n)
    A, W = max_active_sweeps(n, b), num_wavefronts(n, b)
    T = B.clone()
    vs, taus, row0 = torch.empty(W, A, b), torch.empty(W, A), torch.empty(W, A, dtype=torch.int32)
    assert host[1](T.data_ptr(), n, b, A, group, vs.data_ptr(), taus.data_ptr(),
                   row0.data_ptr(), 1, None) == 0
    Tp, lp = chase_wavefront_slices(B, b, True)
    assert _rel(T, Tp) < 3e-4
    assert torch.equal(row0, lp.row0)
    active = lp.row0 < n
    assert torch.equal(taus[~active], lp.taus[~active]) and torch.equal(vs[~active], lp.vs[~active])
    vsw, tw = sweep_major_log(ChaseLog(vs, taus, row0, n, b))
    QT = backtransform_wy_xla(T, vsw, tw, b=b)
    assert _rel(backtransform_wy_xla(QT.T.contiguous(), vsw, tw, b=b), B) < 3e-4


@pytest.mark.parametrize("m,transpose,in_smem", [(33, False, True), (5, True, True), (33, True, False), (7, False, False)])
def test_backtransform_host(host, m, transpose, in_smem):
    n, b = 33, 4
    _, log = chase_wavefront_slices(_band(n, b, 2), b, True)
    vs, taus = sweep_major_log(log)
    X = torch.tensor(np.random.default_rng(m).normal(size=(n, m)).astype(np.float32))
    Y = X.clone()
    S, K, _ = vs.shape
    cw = kc.strip_width(n, m)[0] if in_smem else min(32, m)
    assert host[2](Y.data_ptr(), n, m, vs.data_ptr(), taus.data_ptr(), S, K, b,
                   int(transpose), cw, int(in_smem), None) == 0
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
    assert host[3](A.data_ptr(), B.data_ptr(), k, n, k, alpha,
                   None if C is None else C.data_ptr(), 0 if C is None else C.stride(0),
                   out.data_ptr(), None) == 0
    want = ref.syr2k_ref(A, B, C, alpha=alpha)
    assert torch.equal(out, out.T)
    assert float((out - want).abs().max()) <= 2e-5 * max(float(want.abs().max()), 1.0)


@pytest.mark.parametrize("m,b,smem", [(33, 8, SMEM), (17, 5, SMEM), (40, 8, 1024), (64, 16, SMEM), (8, 8, 0)])
def test_panel_qr_host(host, m, b, smem):
    """Kernel E against panel_qr_body(lapack_sign=False); a budget below
    m * b * 4 bytes puts the panel in global memory."""
    P = torch.tensor(np.random.default_rng(m * b).normal(size=(m, b)).astype(np.float32))
    P[6:, 2] = 0.0  # a degenerate column: sigma == 0 -> tau == 0
    V, T, taus, R = torch.empty(m, b), torch.empty(b, b), torch.empty(b), torch.empty(b, b)
    assert host[4](P.data_ptr(), m, b, V.data_ptr(), T.data_ptr(), taus.data_ptr(),
                   R.data_ptr(), smem, None) == 0
    for got, want in zip((V, T, taus, R), ke.panel_qr_body(P, b, lapack_sign=False)):
        assert float((got - want).abs().max()) <= 5e-5 * max(float(want.abs().max()), 1.0)
