"""The bucket form of kernels A–D, on the CPU.

``jax.vmap`` in the JAX package's ``BatchPlan`` gives each Pallas kernel a
leading grid axis, so a bucket reaches each kernel once per static step.
The port's kernels take the same bucket dimension:

* **Host emulation** (g++ against ``tests/cuda_host/cuda_runtime.h``, as
  tests/test_torch_kernels_host.py compiles them): on buckets of 3–5
  matrices at n = 32–64, the batched launchers of A, B (with and without
  the log), C and D (float32 and bf16) are each bitwise equal to one launch
  a matrix, and held against their batched plain versions at the
  tolerances of tests/test_torch_kernels_host.py.  Kernel B on 2 CTAs over
  4 matrices (fewer CTAs than matrices x sweeps) finishes and gives the
  same bits, with its tickets in groups of one matrix (matrix-major), of
  several and of the whole bucket, as the number of CTAs sets them.
* **Once per bucket**: with the registry's ops wrapped by a counter,
  ``solve_many`` on ``backend="torch"`` calls ``fused_panel_update`` once a
  DBR block and ``bulge_wavefront`` and ``backtransform_wy`` once, for the
  bucket (``trailing_update`` once a block on ``tridiag="unfused"``); a
  bucket over ``kernels.limits.bucket_chunk`` runs in its chunks, each so.
* The operators take a bucket: fakes, FLOP formulas (B x one matrix's) and
  ``opcheck`` with the plain versions as a scratch CPU implementation.
* **Against JAX**: the port's ``solve_many`` against the JAX package's
  ``batch_plan`` (jnp backend) on one numpy bucket, at float32 tolerance
  with sign-aligned columns (tolerance only: ROADMAP Queue 3).
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.backend import registry  # noqa: E402
from repro_torch.core.backtransform import backtransform_wy_xla, sweep_major_log  # noqa: E402
from repro_torch.core.band_reduction import build_stage_schedule  # noqa: E402
from repro_torch.core.bulge_chasing import chase_wavefront, max_active_sweeps, num_wavefronts  # noqa: E402
from repro_torch.kernels import backtransform as kc  # noqa: E402
from repro_torch.kernels import bulge as kb  # noqa: E402
from repro_torch.kernels import fused_panel as ka  # noqa: E402
from repro_torch.kernels import library, limits, ref, work  # noqa: E402
from repro_torch.kernels import syr2k as kd  # noqa: E402
from repro_torch.kernels.cuda_lib import CSRC  # noqa: E402

SHIM = Path(__file__).resolve().parent / "cuda_host"
SMEM = limits.limit("PANEL_QR_SMEM")


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """Kernels A–D compiled for host emulation: their launchers and workspace
    queries, and the switch that runs kernel B's CTAs one after another."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernels for host emulation")
    out = tmp_path_factory.mktemp("cuda_host_bucket")
    procs = {}
    # fused_panel_tiles: kernel A with its GEMV the symmetric product at every
    # m (the row walk's range of m empty), to reach the product's tiles.
    for name in ("fused_panel", "bulge", "backtransform", "syr2k", "fused_panel_tiles"):
        so = out / f"{name}.so"
        src = CSRC / f"{name.replace('_tiles', '')}.cu"
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

    def bind(lib, fn, argtypes, restype):
        f = getattr(libs[lib], fn)
        f.argtypes, f.restype = argtypes, restype
        return f

    return dict(
        a=bind("fused_panel", "fused_panel_update_launch", ka._ARGTYPES, ctypes.c_int),
        a_ws=bind("fused_panel", "fused_panel_update_workspace", ka._WORKSPACE_ARGTYPES, ctypes.c_longlong),
        a_tiles=bind("fused_panel_tiles", "fused_panel_update_launch", ka._ARGTYPES, ctypes.c_int),
        a_tiles_ws=bind("fused_panel_tiles", "fused_panel_update_workspace", ka._WORKSPACE_ARGTYPES,
                        ctypes.c_longlong),
        b=bind("bulge", "bulge_wavefront_launch", kb._ARGTYPES, ctypes.c_int),
        b_ws=bind("bulge", "bulge_wavefront_workspace", kb._WORKSPACE_ARGTYPES, ctypes.c_longlong),
        in_turn=bind("bulge", "emu_run_ctas_in_turn", [ctypes.c_int], None),
        c=bind("backtransform", "backtransform_wy_launch", kc._ARGTYPES, ctypes.c_int),
        c_ws=bind("backtransform", "backtransform_wy_workspace", kc._WORKSPACE_ARGTYPES, ctypes.c_longlong),
        d=bind("syr2k", "syr2k_launch", kd._ARGTYPES, ctypes.c_int),
    )


def _syms(count, n, seed):
    a = np.random.default_rng(seed).normal(size=(count, n, n)).astype(np.float32)
    return torch.tensor(a + a.transpose(0, 2, 1))


def _bands(count, n, b, seed):
    a = _syms(count, n, seed)
    i = torch.arange(n)
    a[:, (i[:, None] - i[None, :]).abs() > b] = 0.0
    return a


def _rel(x, y):
    return float((x.double() - y.double()).abs().max() / max(float(y.abs().max()), 1.0))


def _kernel_a(host, Bv, b, w, cluster, lib="a"):
    """Kernel A's launcher on the views Bv (B, m, m) in one call (``lib``
    "a_tiles": the build whose GEMV is the symmetric product at every m)."""
    batch, m = Bv.shape[0], Bv.shape[-1]
    buf = ka.buffers(m, w, b, cluster, "cpu", host[f"{lib}_ws"], batch)
    err = host[lib](Bv.data_ptr(), Bv.stride(1), Bv.stride(0), batch, m, w, b,
                    *(t.data_ptr() for t in buf.values()), SMEM, cluster, None)
    assert err == 0
    return buf["V"], buf["Ts"]


_BUCKET_CASES = [
    (3, 48, 0, 16, 8, 1, "a"),       # the first block of 3 matrices
    (3, 56, 8, 32, 8, 2, "a"),       # a strided trailing view, the QR over 2 CTAs a matrix
    (5, 40, 4, 12, 4, 3, "a"),       # 5 views, 3-CTA clusters
    (2, 136, 0, 8, 8, 2, "a"),       # panel_gemv the row walk (128 < m)
    (2, 136, 0, 8, 8, 2, "a_tiles"),  # panel_gemv on 3 x 3 tiles of 64, the last ragged
]


@pytest.mark.parametrize(
    "count,n,ci,w,b,cluster,lib",
    _BUCKET_CASES,
    ids=["-".join(map(str, c[:6])) + ("" if c[6] == "a" else "-tiles") for c in _BUCKET_CASES],
)
def test_kernel_a_bucket_bitwise(host, count, n, ci, w, b, cluster, lib):
    """One call on B trailing views B[:, ci:, ci:] equals one call a view
    bit for bit (its buffers and tickets are the view's own), and the
    batched plain version at tests/test_torch_kernels_host.py's tolerance."""
    A = _syms(count, n, n + ci)
    Bk = A.clone()
    Vk, Tk = _kernel_a(host, Bk[:, ci:, ci:], b, w, cluster, lib)
    for i in range(count):
        Bi = A[i : i + 1].clone()
        Vi, Ti = _kernel_a(host, Bi[:, ci:, ci:], b, w, cluster, lib)
        assert torch.equal(Bk[i], Bi[0]) and torch.equal(Vk[i], Vi[0]) and torch.equal(Tk[i], Ti[0])
    Bp = A.clone()
    _, Vp, Tp = ref.fused_panel_update_ref(Bp[:, ci:, ci:], b, w)
    tol = 1e-5 * max(8.0, (n - ci) ** 0.5)
    assert _rel(Bk, Bp) < tol and _rel(Vk, Vp) < tol and _rel(Tk, Tp) < tol


def _kernel_b(host, B, b, ctas, with_log=True):
    """Kernel B's launcher on the bands B (count, n, n) in one call of
    ``ctas`` CTAs; its tickets go in groups of ceil(ctas / min(A, n - 2))
    matrices, sweep-major inside a group."""
    count, n = B.shape[0], B.shape[-1]
    A, W = max_active_sweeps(n, b), num_wavefronts(n, b)
    T = B.clone()
    # NaN in every log slot: the kernel must write the inactive ones too.
    vs = torch.full((count, W, A, b), float("nan"))
    taus = torch.full((count, W, A), float("nan"))
    row0 = torch.full((count, W, A), -1, dtype=torch.int32)
    work = torch.zeros(host["b_ws"](n, count) // 4, dtype=torch.int32)
    assert host["b"](T.data_ptr(), n, b, A, ctas, vs.data_ptr(), taus.data_ptr(), row0.data_ptr(),
                     int(with_log), work.data_ptr(), count, None, None) == 0
    assert int(work[-1]) == count * (n - 2) + ctas  # every sweep taken, then one empty ticket a CTA
    assert bool((work[:-1].view(count, n - 2) == torch.tensor(
        [(n - 3 - s) // b + 1 for s in range(n - 2)], dtype=torch.int32)).all())  # every op published
    return T, vs, taus, row0


@pytest.mark.parametrize("together", [False, True], ids=["ctas_in_turn", "ctas_together"])
@pytest.mark.parametrize(
    "count,n,b,ctas",
    [
        (4, 33, 4, 2),    # 2 CTAs over 4 matrices x 31 sweeps: groups of 1, matrix-major tickets
        (4, 33, 4, 20),   # more CTAs than the bucket's sweeps in flight: one group of 4
        (3, 40, 8, 7),    # one group of 3 (A = 3): sweep-major over the bucket
        (5, 32, 4, 6),    # groups of 2 (A = 4), the last of 1
        (3, 40, 16, 3),   # b = 16 on the instantiation that takes b at run time, groups of 2 (A = 2)
    ],
)
def test_kernel_b_bucket_bitwise(host, count, n, b, ctas, together):
    """One persistent grid over a bucket, its CTAs run one after another or
    together (a sweep then waits on its matrix's previous sweep, taken
    earlier by a running CTA): fewer CTAs than matrices x sweeps finish,
    and T and the log equal one launch a matrix bit for bit, with the log
    and without; held against the batched plain chase."""
    host["in_turn"](int(not together))
    try:
        B = _bands(count, n, b, n + b)
        T, vs, taus, row0 = _kernel_b(host, B, b, ctas)
        T_nolog = _kernel_b(host, B, b, ctas, with_log=False)[0]
        ones = [_kernel_b(host, B[i : i + 1], b, ctas) for i in range(count)]
    finally:
        host["in_turn"](0)
    assert torch.equal(T, T_nolog)
    for i, (Ti, vi, ti, ri) in enumerate(ones):
        assert torch.equal(T[i], Ti[0]) and torch.equal(vs[i], vi[0])
        assert torch.equal(taus[i], ti[0]) and torch.equal(row0[i], ri[0])
    Tp, lp = chase_wavefront(B, b, True)
    assert _rel(T, Tp) < 3e-4
    assert torch.equal(row0, lp.row0)
    active = lp.row0 < n
    assert bool((taus[~active] == 0).all()) and torch.equal(vs[~active], lp.vs[~active])


def _kernel_c(host, X, vs, taus, b, transpose, in_smem):
    count, n, m = X.shape
    S, K = vs.shape[1:3]
    Y = X.clone()
    cw = kc.strip_width(n, m)[0] if in_smem else min(32, m)
    work = torch.empty(count * host["c_ws"](n, S, K, b))
    assert host["c"](Y.data_ptr(), n, m, vs.data_ptr(), taus.data_ptr(), S, K, b, int(transpose), cw,
                     int(in_smem), work.data_ptr(), count, None) == 0
    return Y


@pytest.mark.parametrize("n,b,m,transpose,in_smem", [(33, 4, 9, False, True), (40, 8, 13, True, False),
                                                     (41, 16, 3, True, True)])
def test_kernel_c_bucket_bitwise(host, n, b, m, transpose, in_smem):
    """Both launches (the regroup and the walk) over a bucket of 3 logs:
    bitwise one call a matrix, and the batched plain apply's tolerance."""
    count = 3
    _, log = chase_wavefront(_bands(count, n, b, m), b, True)
    vs, taus = sweep_major_log(log)
    X = torch.tensor(np.random.default_rng(n * m).normal(size=(count, n, m)).astype(np.float32))
    Y = _kernel_c(host, X, vs.contiguous(), taus.contiguous(), b, transpose, in_smem)
    for i in range(count):
        Yi = _kernel_c(host, X[i : i + 1], vs[i : i + 1].contiguous(), taus[i : i + 1].contiguous(), b,
                       transpose, in_smem)
        assert torch.equal(Y[i], Yi[0])
    assert _rel(Y, backtransform_wy_xla(X, vs, taus, b=b, transpose=transpose)) < 1e-5 * 8


def _kernel_d(host, A, B, C, alpha, bf16):
    count, n, k = A.shape
    out = torch.full((count, n, n), float("nan")).to(A.dtype)
    assert host["d"](A.data_ptr(), B.data_ptr(), k, n * k, n, k, alpha,
                     None if C is None else C.data_ptr(), 0 if C is None else C.stride(1),
                     0 if C is None else C.stride(0), out.data_ptr(), int(bf16), count, None) == 0
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,k,c_view", [(40, 37, True), (64, 16, None), (33, 8, False)])
def test_kernel_d_bucket_bitwise(host, dtype, n, k, c_view):
    """Kernel D on a bucket of 3 (C strided views of a larger stack, C
    absent, or contiguous): bitwise one call a matrix, exactly symmetric,
    and the batched plain version's tolerance (bf16: one bf16 rounding)."""
    count = 3
    rng = np.random.default_rng(n + k)
    A = torch.tensor(rng.normal(size=(count, n, k)).astype(np.float32)).to(dtype)
    B = torch.tensor(rng.normal(size=(count, n, k)).astype(np.float32)).to(dtype)
    C = None if c_view is None else _syms(count, n + 3, n)[:, 3:, 3:] if c_view else _syms(count, n, n)
    C = None if C is None else C.to(dtype)
    bf16 = dtype == torch.bfloat16
    out = _kernel_d(host, A, B, C, -1.0, bf16)
    for i in range(count):
        Ci = None if C is None else C[i : i + 1]
        assert torch.equal(out[i], _kernel_d(host, A[i : i + 1], B[i : i + 1], Ci, -1.0, bf16)[0])
    assert torch.equal(out, out.mT)
    want = ref.syr2k_ref(A.float(), B.float(), None if C is None else C.float(), alpha=-1.0)
    tol = 2 ** -8 if bf16 else 2e-5
    assert float((out.float() - want).abs().max()) <= tol * max(float(want.abs().max()), 1.0)


# ---------------------------------------------------------------- the executor
COUNTED = ("fused_panel_update", "trailing_update", "bulge_wavefront", "bulge_chase", "backtransform_wy")


@pytest.fixture
def counted(monkeypatch):
    """The registry's torch ops, each wrapped by a call counter."""
    registry.resolve("syr2k", "torch")  # build the table
    calls = {op: 0 for op in COUNTED}
    for op in COUNTED:
        fn = registry._IMPLS[(op, "torch")]

        def wrapped(*args, _fn=fn, _op=op, **kw):
            calls[_op] += 1
            return _fn(*args, **kw)

        monkeypatch.setitem(registry._IMPLS, (op, "torch"), wrapped)
    return calls


@pytest.mark.parametrize("tridiag", ["fused", "unfused"])
@pytest.mark.parametrize("op", ["eigh", "eigvals"])
def test_solve_many_calls_each_op_once_per_bucket(counted, tridiag, op):
    from repro_torch.solver import EvdConfig, solve_many

    n, count, cfg = 32, 5, EvdConfig(b=4, nb=8, tridiag=tridiag, backend="torch")
    blocks = len(build_stage_schedule(n, 4, 8).entries)
    solve_many(_syms(count, n, 0), cfg, op=op, device="cpu")
    got = {k: v for k, v in counted.items() if v}
    first = {"fused_panel_update": blocks} if tridiag == "fused" else {"trailing_update": blocks}
    if op == "eigvals":
        second = {"bulge_wavefront": 1} if tridiag == "fused" else {"bulge_chase": 1}
    else:  # the unfused log comes from the plain chase, no op
        second = {"bulge_wavefront": 1, "backtransform_wy": 1} if tridiag == "fused" else {"backtransform_wy": 1}
    assert got == {**first, **second}


def test_solve_many_chunks_a_bucket_over_the_cap(counted, monkeypatch):
    """A bucket over ``bucket_chunk(n)`` runs in the fewest chunks, each op
    once a chunk, and gives the bits of the unchunked bucket."""
    from repro_torch.solver import EvdConfig, solve_many

    n, count, cfg = 16, 7, EvdConfig(b=4, nb=8, backend="torch")
    A = _syms(count, n, 1)
    w, V = solve_many(A, cfg, device="cpu")
    monkeypatch.setitem(limits.LIMITS, "BUCKET_BYTES", 3 * 4 * n * n)
    assert limits.bucket_chunk(n) == 3 and limits.bucket_calls(count, n) == 3
    for op in counted:
        counted[op] = 0
    wc, Vc = solve_many(A, cfg, device="cpu")
    blocks = len(build_stage_schedule(n, 4, 8).entries)
    assert {k: v for k, v in counted.items() if v} == {
        "fused_panel_update": 3 * blocks, "bulge_wavefront": 3, "backtransform_wy": 3}
    assert torch.equal(w, wc) and torch.equal(V, Vc)


@pytest.mark.parametrize("panel_method", ["geqrf", "householder"])
def test_band_reduce_bucket_panel_methods(panel_method):
    """The unfused band reduction of a bucket factors each panel of every
    matrix in one call of the panel factor (both plain factors take a
    stack) and matches one matrix at a time; kernel E, which factors one
    panel a call, refuses a bucket."""
    from repro_torch.core.band_reduction import band_reduce
    from repro_torch.core.panel_qr import panel_qr_householder

    n, b, nb, count = 32, 4, 8, 3
    tol = 1e-5 * 8  # batched and single matmuls sum in other orders
    A = _syms(count, n, 2)
    Bk, rk = band_reduce(A, b, nb, panel_method=panel_method, backend="torch", return_reflectors=True)
    for i in range(count):
        Bi, ri = band_reduce(A[i], b, nb, panel_method=panel_method, backend="torch", return_reflectors=True)
        assert _rel(Bk[i], Bi) < tol and _rel(rk.V[i], ri.V) < tol and _rel(rk.T[i], ri.T) < tol
    P = A[:, :, :b]
    got = panel_qr_householder(P)
    for i in range(count):
        for x, y in zip(got, panel_qr_householder(P[i])):
            assert _rel(x[i], y) < tol
    with pytest.raises(ValueError, match="bucket"):
        band_reduce(A, b, nb, panel_method="kernel", backend="torch")


# ---------------------------------------------------------------- the operators
def test_operator_fakes_and_formulas_take_a_bucket():
    from torch._subclasses.fake_tensor import FakeTensorMode

    count, n, b, w = 3, 64, 8, 16
    with FakeTensorMode():
        Bv = torch.empty((count, n, n))
        V, Ts = library._fake_fused_panel_update(Bv[:, w:, w:], b, w)
        T, vs, taus, row0 = library._fake_bulge_wavefront(Bv, b)
        out = library._fake_trailing_update(Bv[:, :w, :w], Bv[:, :w, :8], Bv[:, :w, :8])
    W, A = num_wavefronts(n, b), max_active_sweeps(n, b)
    assert tuple(V.shape) == (count, n - w, w) and tuple(Ts.shape) == (count, w // b, b, b)
    assert tuple(T.shape) == (count, n, n) and tuple(vs.shape) == (count, W, A, b)
    assert tuple(taus.shape) == tuple(row0.shape) == (count, W, A) and row0.dtype == torch.int32
    assert tuple(out.shape) == (count, w, w)
    formulas = {name: f for name, (_, _, _, f) in library._OPS.items()}
    for name, shapes, one in (
        ("fused_panel_update", ((count, n, n), b, w), work.fused_panel_update(n, w, b)),
        ("bulge_wavefront", ((count, n, n), b), work.bulge_wavefront(n, b)),
        ("backtransform_wy", ((count, n, 5), (count, n - 2, 8, b), None, b, False),
         work.backtransform_wy(n, 5, n - 2, 8, b)),
        ("trailing_update", (None, None, (count, n, w)), work.syr2k(n, w)),
    ):
        assert formulas[name](*shapes) == round(count * one.total_flops)


@pytest.fixture(scope="module")
def bucket_ops():
    """The operators' schemas and fakes under a scratch namespace, the batched
    plain versions as the CPU implementation."""
    from repro_torch.core.bulge_chasing import chase_wavefront_slices

    plain = {
        "fused_panel_update": lambda Bv, b, w: ref.fused_panel_update_ref(Bv, b, w)[1:],
        "bulge_wavefront": lambda B, b: (lambda T, lg: (T, lg.vs, lg.taus, lg.row0))(
            *chase_wavefront_slices(B, b, True)),
        "bulge_chase": lambda B, b: chase_wavefront(B, b),
        "backtransform_wy": lambda X, vs, taus, b, t: backtransform_wy_xla(X, vs, taus, b=b, transpose=t),
        "syr2k": lambda A, B, C, alpha: ref.syr2k_ref(A, B, C, alpha=alpha),
        "trailing_update": lambda C, Y, Z: ref.syr2k_ref(Z, Y, C, alpha=-1.0),
    }
    ns = "repro_torch_opcheck_bucket"
    lib = torch.library.Library(ns, "DEF")
    for name, fn in plain.items():
        schema, _, fake, _ = library._OPS[name]
        lib.define(schema)
        lib.impl(name, fn, "CPU")
        torch.library.register_fake(f"{ns}::{name}", fake, lib=lib)
    yield getattr(torch.ops, ns)
    lib._destroy()


@pytest.mark.parametrize("name", ["fused_panel_update", "bulge_wavefront", "bulge_chase", "backtransform_wy",
                                  "syr2k", "trailing_update"])
def test_opcheck_on_a_bucket(bucket_ops, name):
    count, n, b, w = 2, 32, 4, 8
    A = _syms(count, n, 3)
    band = _bands(count, n, b, 4)
    _, log = chase_wavefront(band, b, True)
    vs, taus = sweep_major_log(log)
    X = torch.tensor(np.random.default_rng(5).normal(size=(count, n, 6)).astype(np.float32))
    Y, Z = A[:, w:, :w].contiguous(), A[:, w:, w : 2 * w].contiguous()
    args = {"fused_panel_update": (A.clone()[:, 4:, 4:], b, w), "bulge_wavefront": (band, b),
            "bulge_chase": (band, b), "backtransform_wy": (X, vs, taus, b, True),
            "syr2k": (Z, Y, A[:, w:, w:], -1.0), "trailing_update": (A[:, w:, w:], Y, Z)}[name]
    result = torch.library.opcheck(getattr(bucket_ops, name), args)
    assert set(result.values()) == {"SUCCESS"}, result


# ---------------------------------------------------------------- against JAX
@pytest.mark.parametrize("tridiag", ["fused", "unfused"])
def test_solve_many_against_jax_batch_plan(tridiag):
    import jax.numpy as jnp

    from repro.solver import EvdConfig as JaxConfig
    from repro.solver import batch_plan as jax_batch_plan
    from repro_torch.solver import EvdConfig, solve_many

    count, n = 4, 32
    a = _syms(count, n, 11).numpy()
    w, V = solve_many(a, EvdConfig(b=4, nb=16, tridiag=tridiag), device="cpu")
    wj, Vj = jax_batch_plan(n, count, jnp.float32, JaxConfig(backend="jnp", b=4, nb=16, tridiag=tridiag))(
        jnp.asarray(a))
    wj, Vj = np.asarray(wj), np.asarray(Vj)
    wt, Vt = w.numpy(), V.numpy()
    np.testing.assert_allclose(wt, wj, atol=1e-5 * float(np.abs(wj).max()))
    s = np.sign(np.sum(Vt * Vj, axis=-2, keepdims=True))
    np.testing.assert_allclose(Vt * s, Vj, atol=1e-4)
