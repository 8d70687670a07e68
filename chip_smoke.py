#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA H100 and check them.

    python3 chip_smoke.py          # from the root of a checkout; needs one card

Phases, each printing its own lines:

1. Device: the card's name and power limit (nvidia-smi), then the build of
   every hand-written kernel from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together) and its time.
2. Each kernel against its plain PyTorch version on the card, at the shapes
   the n = 4096 paths give it: max abs / rel error and the tolerance,
   the kernel's time (CUDA events, warm), the plain version's time, a
   library yardstick where one exists, and the least time the card could
   take for the same work (``bound_ms``, from bytes and fp32 operations).
   Kernels A-C (fused path), D (``syr2k`` / ``trailing_update``) and E
   (the standalone ``panel_qr``).
3. The main path, ``plan(4096, float32, EvdConfig())(A)`` and ``.eigvals(A)``
   on a seeded random symmetric A: launch counters reset just before and
   read just after (each kernel must have run), eigenvalues against
   ``torch.linalg.eigvalsh``, residual and orthogonality, per-stage times
   (each stage closed by a synchronize), end-to-end time beside
   ``torch.linalg.eigh`` / ``eigvalsh`` (cuSOLVER) and the peak memory.
4. ``inverse_pth_root`` at n = 1024, p = 4 on a seeded PSD matrix, against
   V diag(w^-1/4) V^T from ``torch.linalg.eigh`` in float64.
5. The unfused first stage at n = 4096: ``plan(4096, float32,
   EvdConfig(tridiag="unfused"))(A)`` and ``.eigvals(A)`` against the gates
   of phase 3, each with the counters reset just before and read just after
   (one ``trailing_update`` launch per DBR block, kernel B once for the
   eigvals run), its stage times, and ``band_reduce(A, 8, 256,
   panel_method="kernel")`` (one ``panel_qr`` launch per panel) with the
   band's eigenvalues against ``torch.linalg.eigvalsh(A)``.

Then one JSON line with the kernels, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.  Any failed check raises, so the
script exits non-zero and prints no result; so does a machine without a
CUDA device, or a directory that holds this script and nothing else of the
repository.  TF32 is switched off (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32``): every float32 product, the plain
versions' and the yardsticks', runs in full float32.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

N_MAIN = 4096
N_ROOT = 1024
SEED = 0

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 rate and the float32
# rate outside the tensor cores (the kernels use no tensor cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

# Tolerances of the kernel-vs-plain comparisons, relative to the largest
# entry of the plain result: fp32 sums in other orders, grown by the
# reduction length.
TOL_A = 1e-5 * max(8.0, N_MAIN ** 0.5)
TOL_B = 5e-4  # ~3n/b dependent window updates per entry in fp32
TOL_C = 1e-5 * max(8.0, N_MAIN ** 0.5)
# Kernels D and E: the JAX package's own kernel tolerances
# (tests/test_kernels.py): 2e-5 max|ref| for syr2k, and 5e-5 max(|ref|, 1)
# for each of the panel QR's V, T, taus and R.
TOL_D = 2e-5
TOL_E = 5e-5
# Main-path checks: eigenvalues as tests/test_core_eigh.py (3e-4 max|w|);
# ||A V - V diag(w)||_F / ||A||_F and max |V^T V - I|.
TOL_EIG = 3e-4
TOL_RESID = 1e-4
TOL_ORTH = 1e-3
TOL_ROOT = 1e-3


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, setup=None) -> float:
    """Mean time of ``fn(*setup())`` over ``reps`` calls issued back to back
    between two CUDA events, after one warm-up call; ``setup`` runs for
    every call before the timed window.  Back to back, a call's host-side
    work overlaps the device work queued before it, so a kernel that runs
    longer than its launcher's host work is timed on the device alone."""
    args = [setup() if setup else () for _ in range(reps + 1)]
    fn(*args[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for a in args[1:]:
        fn(*a)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_split(torch, fn):
    """Device time per CUDA kernel name of one ``fn()`` call, from
    ``torch.profiler`` (empty when the profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if us > 0:
            name = re.sub(r"^void |\(anonymous namespace\)::", "", ev.key).split("(")[0]
            rows.append((name[:48], us / 1e3, ev.count))
    return sorted(rows, key=lambda r: -r[1])


def rel_err(x, y) -> float:
    x, y = x.double(), y.double()
    return float((x - y).abs().max() / max(float(y.abs().max()), 1e-30))


def phase_kernels(torch, gen):
    """Phase 2: each kernel against its plain version at main-path shapes."""
    from repro_torch.core.backtransform import backtransform_wy_xla, sweep_major_log
    from repro_torch.core.band_reduction import band_reduce, build_stage_schedule
    from repro_torch.core.bulge_chasing import chase_wavefront_slices
    from repro_torch.kernels import ref
    from repro_torch.kernels.backtransform import backtransform_wy_cuda
    from repro_torch.kernels.bulge import bulge_wavefront_cuda
    from repro_torch.kernels.fused_panel import fused_panel_update_cuda
    from repro_torch.kernels.limits import limit
    from repro_torch.kernels.panel import panel_qr_body, panel_qr_cuda
    from repro_torch.kernels.syr2k import syr2k_cuda, trailing_update_cuda
    from repro_torch.solver import resolve_blocking

    n = N_MAIN
    dec = resolve_blocking(n, device_type="cuda")
    b = dec.b
    A = torch.randn((n, n), generator=gen, device="cuda")
    A = A + A.T
    rows = {}

    # --- kernel A: the first block of the main path (m = n, w = nb) ------
    e0 = build_stage_schedule(n, b, dec.nb).entries[0]
    m, w = e0.m, e0.w
    Bk, Vk, Tk = fused_panel_update_cuda(A.clone(), b, w)
    Bp, Vp, Tp = ref.fused_panel_update_ref(A.clone(), b, w)
    torch.cuda.synchronize()
    errs = [rel_err(Bk, Bp), rel_err(Vk, Vp), rel_err(Tk, Tp)]
    max_abs = max(float((Bk - Bp).abs().max()), float((Vk - Vp).abs().max()), float((Tk - Tp).abs().max()))
    require(max(errs) < TOL_A, f"kernel A vs plain rel err {errs} >= {TOL_A}")
    ms = cuda_ms(torch, lambda B: fused_panel_update_cuda(B, b, w), 5, lambda: (A.clone(),))
    plain_ms = cuda_ms(torch, lambda B: ref.fused_panel_update_ref(B, b, w), 2, lambda: (A.clone(),))
    mt = m - w
    C = A[w:, w:].contiguous()
    Z = torch.randn((mt, w), generator=gen, device="cuda")
    V = torch.randn((mt, w), generator=gen, device="cuda")
    lib_ms = cuda_ms(torch, lambda: C - Z @ V.T - V @ Z.T, 5)
    q = w // b
    flops = sum(2.0 * m * (m - (j + 1) * b) * b + 12.0 * m * j * b * b for j in range(q))
    flops += 2.0 * mt * mt * w
    bms, by = bound((2.0 * m * m + m * w + q * b * b) * 4, flops)
    print(f"phase 2 kernel A fused_panel_update m={m} w={w} b={b}: rel err B/V/T "
          f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol {TOL_A:.1e}) max_abs_err={max_abs:.3e}")
    print(f"phase 2 kernel A ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}) "
          f"trailing-phase yardstick C - Z V^T - V Z^T (2 torch.matmul) ms={lib_ms:.4f}")
    split = device_split(torch, lambda: fused_panel_update_cuda(A.clone(), b, w))
    print("phase 2 kernel A device time by CUDA kernel (torch.profiler): " + (
        "; ".join(f"{k} {t:.3f} ms x{c}" for k, t, c in split[:8]) or "not measured"))
    rows["fused_panel_update"] = dict(max_abs_err=max_abs, compared="B, V and Ts entrywise",
                                      ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                      bound_by=by, library_ms=lib_ms,
                                      library="C - Z @ V.T - V @ Z.T, the trailing phase only")

    # --- kernel B: the chase of the main path's band matrix, with the log -
    Bband = band_reduce(A, b, dec.nb)
    Tk, lk = bulge_wavefront_cuda(Bband, b, return_log=True)
    t0 = time.perf_counter()
    Tp, lp = chase_wavefront_slices(Bband, b, True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    require(torch.equal(lk.row0, lp.row0), "kernel B row0 differs from plain")
    active = lp.row0 < n
    require(bool((lk.taus[~active] == 0).all()), "kernel B inactive slot with tau != 0")
    eT = rel_err(Tk, Tp)
    # The log is held to what it must satisfy, B = Q2 T Q2^T, applied with
    # the plain back-transform: reflector by reflector, a log is only
    # determined up to rounding amplified by 1/|x| where the column x to
    # eliminate is already tiny, so an entrywise comparison with the plain
    # log (reported: tau v v^T) is ill-posed at this size.
    vs_k, taus_k = sweep_major_log(lk)
    QT = backtransform_wy_xla(Tk, vs_k, taus_k, b=b)
    recon = backtransform_wy_xla(QT.T.contiguous(), vs_k, taus_k, b=b)
    eR = rel_err(recon, Bband)
    Hk = lk.taus[active][:, None, None] * lk.vs[active][:, :, None] * lk.vs[active][:, None, :]
    Hp = lp.taus[active][:, None, None] * lp.vs[active][:, :, None] * lp.vs[active][:, None, :]
    eH = rel_err(Hk, Hp)
    # T is held through what is well conditioned: its spectrum against the
    # plain T's, its exact tridiagonal structure, and the reconstruction.
    off = (torch.arange(n, device="cuda")[:, None] - torch.arange(n, device="cuda")[None, :]).abs() > 1
    lam_k = torch.linalg.eigvalsh(Tk.double())
    lam_p = torch.linalg.eigvalsh(Tp.double())
    eL = rel_err(lam_k, lam_p)
    max_abs = float((lam_k - lam_p).abs().max())
    require(bool((Tk[off] == 0).all()), "kernel B output is not exactly tridiagonal")
    require(eL < TOL_B and eR < TOL_B,
            f"kernel B: eigenvalues of T vs plain {eL}, ||Q2 T Q2^T - B|| {eR} (tol {TOL_B})")
    Tv = bulge_wavefront_cuda(Bband, b)
    require(torch.equal(Tv, Tk), "kernel B values-only run differs from the logged run")
    ms = cuda_ms(torch, lambda: bulge_wavefront_cuda(Bband, b, return_log=True), 3)
    n_ops = int(active.sum())
    Wn, An = lk.taus.shape
    bms, by = bound((2.0 * n * n + Wn * An * (b + 2)) * 4, 26.0 * b * b * n_ops)
    print(f"phase 2 kernel B bulge_wavefront n={n} b={b} wavefronts={Wn} slots={An} ops={n_ops}: "
          f"eig(T) vs plain {eL:.3e} (max_abs_err={max_abs:.3e}), Q2 T Q2^T vs B {eR:.3e} "
          f"(tol {TOL_B:.1e}); T exactly tridiagonal; row0 exact; entrywise vs plain, "
          f"reported only: T {eT:.3e}, tau v v^T {eH:.3e}")
    print(f"phase 2 kernel B ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}) "
          f"library: none")
    rows["bulge_wavefront"] = dict(max_abs_err=max_abs, compared="eigenvalues of T",
                                   ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                   bound_by=by, library_ms=None)

    # --- kernel C: Q2 and Q2^T on a full (n, n) panel ---------------------
    vs, taus = sweep_major_log(lk)
    X = torch.randn((n, n), generator=gen, device="cuda")
    errs, max_abs = [], 0.0
    for transpose in (False, True):
        Yk = backtransform_wy_cuda(X, vs, taus, b=b, transpose=transpose)
        Yp = backtransform_wy_xla(X, vs, taus, b=b, transpose=transpose)
        torch.cuda.synchronize()
        errs.append(rel_err(Yk, Yp))
        max_abs = max(max_abs, float((Yk - Yp).abs().max()))
    require(max(errs) < TOL_C, f"kernel C vs plain rel err {errs} >= {TOL_C}")
    ms = cuda_ms(torch, lambda: backtransform_wy_cuda(X, vs, taus, b=b), 3)
    plain_ms = cuda_ms(torch, lambda: backtransform_wy_xla(X, vs, taus, b=b), 1)
    S, K, _ = vs.shape
    n_refl = int((taus != 0).sum())
    bms, by = bound((2.0 * n * n + S * K * (b + 1)) * 4, 4.0 * b * n_refl * n)
    print(f"phase 2 kernel C backtransform_wy (n, m)=({n}, {n}) S={S} K={K}: rel err Q2/Q2^T "
          f"{errs[0]:.3e}/{errs[1]:.3e} (tol {TOL_C:.1e}) max_abs_err={max_abs:.3e}")
    print(f"phase 2 kernel C ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}) library: none")
    rows["backtransform_wy"] = dict(max_abs_err=max_abs, compared="Q2 X and Q2^T X entrywise",
                                    ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                    bound_by=by, library_ms=None)

    # --- kernel D: the first trailing update of the unfused path ----------
    # C is the strided trailing view A[w:, w:], as band_reduce hands it over.
    C = A[w:, w:]
    Y = torch.randn((mt, w), generator=gen, device="cuda")
    Z = torch.randn((mt, w), generator=gen, device="cuda")
    errs, max_abs = [], 0.0
    for label, Dk, Dp in (
        ("C - Z Y^T - Y Z^T", trailing_update_cuda(C, Y, Z), ref.syr2k_ref(Z, Y, C, alpha=-1.0)),
        ("Z Y^T + Y Z^T (C absent)", syr2k_cuda(Z, Y), ref.syr2k_ref(Z, Y)),
    ):
        torch.cuda.synchronize()
        require(torch.equal(Dk, Dk.T), f"kernel D output not exactly symmetric ({label})")
        errs.append(float((Dk - Dp).abs().max()) / float(Dp.abs().max()))
        max_abs = max(max_abs, float((Dk - Dp).abs().max()))
    require(max(errs) < TOL_D, f"kernel D vs plain rel err {errs} >= {TOL_D}")
    ms = cuda_ms(torch, lambda: trailing_update_cuda(C, Y, Z), 10)
    plain_ms = cuda_ms(torch, lambda: ref.syr2k_ref(Z, Y, C, alpha=-1.0), 5)
    lib_ms = cuda_ms(torch, lambda: C - Z @ Y.T - Y @ Z.T, 10)
    lower = mt * (mt + 1) / 2
    bms, by = bound((2.0 * mt * w + lower + mt * mt) * 4, 4.0 * w * lower)
    print(f"phase 2 kernel D trailing_update (n, k)=({mt}, {w}): rel err with C / C absent "
          f"{errs[0]:.3e}/{errs[1]:.3e} (tol {TOL_D:.0e}) max_abs_err={max_abs:.3e}; "
          f"exactly symmetric")
    print(f"phase 2 kernel D ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}) "
          f"library C - Z Y^T - Y Z^T (2 torch.matmul) ms={lib_ms:.4f}")
    rows["syr2k"] = dict(max_abs_err=max_abs, compared="C + alpha (A B^T + B A^T) entrywise, with "
                         "and without C; exact symmetry", ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, library_ms=lib_ms,
                         library="C - Z @ Y.T - Y @ Z.T (2 torch.matmul)")

    # --- kernel E: the path's largest panel, and one above the smem budget -
    for m_e in (n - b, 2 * n):
        P = torch.randn((m_e, b), generator=gen, device="cuda")
        got = panel_qr_cuda(P)
        want = panel_qr_body(P, b, lapack_sign=False)
        torch.cuda.synchronize()
        errs = [float((x - y).abs().max()) / max(float(y.abs().max()), 1.0) for x, y in zip(got, want)]
        max_abs = max(float((x - y).abs().max()) for x, y in zip(got, want))
        require(max(errs) < TOL_E, f"kernel E (m={m_e}) vs plain rel err V/T/taus/R {errs} >= {TOL_E}")
        ms = cuda_ms(torch, lambda: panel_qr_cuda(P), 20)
        plain_ms = cuda_ms(torch, lambda: panel_qr_body(P, b, lapack_sign=False), 3)
        geqrf_ms = cuda_ms(torch, lambda: torch.geqrf(P), 10)
        flops = sum(3.0 * (m_e - j) + 4.0 * (m_e - j) * (b - 1 - j) + 2.0 * (m_e - j) * j
                    for j in range(b)) + b ** 3 / 3.0
        bms, by = bound((2.0 * m_e * b + 2.0 * b * b + b) * 4, flops)
        in_smem = m_e * b * 4 <= limit("PANEL_QR_SMEM")
        print(f"phase 2 kernel E panel_qr (m, b)=({m_e}, {b}) panel in "
              f"{'shared' if in_smem else 'global'} memory: rel err V/T/taus/R "
              + "/".join(f"{e:.3e}" for e in errs) + f" (tol {TOL_E:.0e}) max_abs_err={max_abs:.3e}")
        print(f"phase 2 kernel E ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.6f} ({by}) "
              f"nearest call torch.geqrf (LAPACK signs, no T) ms={geqrf_ms:.4f}")
        if m_e == n - b:
            rows["panel_qr"] = dict(max_abs_err=max_abs, compared="V, T, taus and R entrywise",
                                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                                    library_ms=geqrf_ms,
                                    library="torch.geqrf, the nearest call: LAPACK signs, no T")
    return rows


def max_eig_err(w, w_ref) -> float:
    return float((w.double() - w_ref).abs().max()) / float(w_ref.abs().max())


def check_evd(torch, phase: str, A, w, V):
    """The main-path gates on ``w, V = plan(A)``; returns eigvalsh(A) in
    float64."""
    n = A.shape[0]
    w_ref = torch.linalg.eigvalsh(A.double())
    scale = float(w_ref.abs().max())
    e_eig = max_eig_err(w, w_ref)
    Ad, Vd = A.double(), V.double()
    resid = float(torch.linalg.norm(Ad @ Vd - Vd * w.double()[None, :]) / torch.linalg.norm(Ad))
    col = float(torch.linalg.norm(Ad @ Vd - Vd * w.double()[None, :], dim=0).max()) / scale
    orth = float((Vd.T @ Vd - torch.eye(n, dtype=torch.float64, device="cuda")).abs().max())
    print(f"{phase} eigenvalues max|w - w_ref|/max|w| = {e_eig:.3e} (tol {TOL_EIG:.0e}); "
          f"||AV - VW||_F/||A||_F = {resid:.3e} (tol {TOL_RESID:.0e}); worst column "
          f"||Av - wv||/||A||_2 = {col:.3e}; max|V^T V - I| = {orth:.3e} (tol {TOL_ORTH:.0e})")
    require(e_eig < TOL_EIG, f"{phase} eigenvalues")
    require(resid < TOL_RESID, f"{phase} residual")
    require(orth < TOL_ORTH, f"{phase} orthogonality")
    require(bool(torch.isfinite(V).all()) and tuple(V.shape) == (n, n), f"{phase} V finite, (n, n)")
    return w_ref


def stage_times(torch, phase: str, A, pl) -> None:
    """One more EVD through the plan's stages, each closed by a synchronize."""
    from repro_torch.solver.plan import _execute

    stages = {}
    last = [time.perf_counter()]

    def mark(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = (now - last[0]) * 1e3
        last[0] = now

    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    _execute(A, pl, True, on_stage=mark)
    print(f"{phase} stages ms: " + ", ".join(f"{k}={v:.1f}" for k, v in stages.items()))


def phase_main_path(torch, gen):
    """Phase 3: the main path at n = 4096 through the plan API."""
    from repro_torch.kernels import cuda_lib
    from repro_torch.solver import EvdConfig, plan

    n = N_MAIN
    A = torch.randn((n, n), generator=gen, device="cuda")
    A = A + A.T
    pl = plan(n, torch.float32, EvdConfig())
    print(f"phase 3 {pl.describe()}")
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, V = pl(A)
    torch.cuda.synchronize()
    e2e_ms = (time.perf_counter() - t0) * 1e3
    launches = cuda_lib.launch_counts()
    device_launches = cuda_lib.device_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 3 launches on the main path: {launches}; CUDA launches {device_launches}")
    require(all(launches[op] > 0 for op in ("fused_panel_update", "bulge_wavefront", "backtransform_wy")),
            f"a kernel did not run on the main path: {launches}")

    w_ref = check_evd(torch, "phase 3", A, w, V)
    stage_times(torch, "phase 3", A, pl)

    out = {}
    ev_ms = wall_ms(torch, lambda: out.setdefault("w", pl.eigvals(A)))
    w2 = out["w"]
    require(max_eig_err(w2, w_ref) < TOL_EIG, "main-path eigvals()")
    torch.linalg.eigh(A)  # warm cuSOLVER
    eigh_ms = wall_ms(torch, lambda: torch.linalg.eigh(A))
    eigvalsh_ms = wall_ms(torch, lambda: torch.linalg.eigvalsh(A))
    print(f"phase 3 end to end n={n} fp32: plan(A) {e2e_ms:.1f} ms, eigvals {ev_ms:.1f} ms; "
          f"torch.linalg.eigh {eigh_ms:.1f} ms, eigvalsh {eigvalsh_ms:.1f} ms; "
          f"peak memory {peak / 2**20:.0f} MiB")
    return launches, device_launches


def phase_inverse_root(torch, gen):
    """Phase 4: inverse_pth_root at the Shampoo block size."""
    from repro_torch.solver import EvdConfig, plan

    n, p, eps = N_ROOT, 4, 1e-6
    G = torch.randn((n, 2 * n), generator=gen, device="cuda") / (2 * n) ** 0.5
    S = G @ G.T + 0.1 * torch.eye(n, device="cuda")
    X = plan(n, torch.float32, EvdConfig()).inverse_pth_root(S, p, eps=eps)
    w, V = torch.linalg.eigh(S.double())
    ridge = eps * max(float(w.max()), 1e-30)
    X_ref = (V * (w.clamp(min=0) + ridge).pow(-1.0 / p)[None, :]) @ V.T
    err = rel_err(X, X_ref)
    print(f"phase 4 inverse_pth_root n={n} p={p}: rel err vs float64 eigh {err:.3e} (tol {TOL_ROOT:.0e})")
    require(err < TOL_ROOT and bool(torch.isfinite(X).all()), "inverse_pth_root")


def phase_unfused(torch, gen):
    """Phase 5: the unfused first stage at n = 4096 (kernels D, B, C and,
    through ``panel_method="kernel"``, E)."""
    from repro_torch.core.band_reduction import band_reduce, build_stage_schedule
    from repro_torch.kernels import cuda_lib
    from repro_torch.solver import EvdConfig, plan

    n = N_MAIN
    A = torch.randn((n, n), generator=gen, device="cuda")
    A = A + A.T
    pl = plan(n, torch.float32, EvdConfig(tridiag="unfused"))
    schedule = build_stage_schedule(n, pl.b, pl.nb)
    blocks = len(schedule.entries)
    print(f"phase 5 {pl.describe()}; {blocks} DBR blocks, {schedule.num_panels} panels")

    def expect(label, launches, want):
        got = {op: launches[op] for op in launches if launches[op] or op in want}
        print(f"phase 5 launches, {label}: {got}")
        require(got == want, f"phase 5 {label}: launches {got}, expected {want}")

    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w, V = pl(A)
    torch.cuda.synchronize()
    e2e_ms = (time.perf_counter() - t0) * 1e3
    launches = cuda_lib.launch_counts()
    device_launches = cuda_lib.device_launch_counts()
    # The chase with a log is plain tensor code on the card (chase_wavefront).
    expect("plan(A)", launches, {"trailing_update": blocks, "backtransform_wy": 1})
    w_ref = check_evd(torch, "phase 5", A, w, V)
    stage_times(torch, "phase 5", A, pl)

    out = {}
    cuda_lib.reset_launch_counts()
    ev_ms = wall_ms(torch, lambda: out.setdefault("w", pl.eigvals(A)))
    expect(".eigvals(A)", cuda_lib.launch_counts(),
           {"trailing_update": blocks, "bulge_wavefront": 1})
    e_ev = max_eig_err(out["w"], w_ref)
    print(f"phase 5 eigvals max|w - w_ref|/max|w| = {e_ev:.3e} (tol {TOL_EIG:.0e})")
    require(e_ev < TOL_EIG, "phase 5 eigvals()")
    print(f"phase 5 end to end n={n} fp32, tridiag=unfused: plan(A) {e2e_ms:.1f} ms, "
          f"eigvals {ev_ms:.1f} ms")

    cuda_lib.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Bband = band_reduce(A, pl.b, pl.nb, panel_method="kernel")
    torch.cuda.synchronize()
    br_ms = (time.perf_counter() - t0) * 1e3
    panel_launches = cuda_lib.launch_counts()
    expect('band_reduce(panel_method="kernel")', panel_launches,
           {"trailing_update": blocks, "panel_qr": schedule.num_panels})
    e_band = max_eig_err(torch.linalg.eigvalsh(Bband.double()), w_ref)
    i = torch.arange(n, device="cuda")
    require(bool((Bband[(i[:, None] - i[None, :]).abs() > pl.b] == 0).all()),
            "phase 5 band_reduce output is not banded")
    print(f"phase 5 band_reduce(A, {pl.b}, {pl.nb}, panel_method=\"kernel\") {br_ms:.1f} ms: "
          f"eigenvalues of the band vs eigvalsh(A) {e_band:.3e} (tol {TOL_EIG:.0e})")
    require(e_band < TOL_EIG, "phase 5 band_reduce(panel_method='kernel') eigenvalues")
    return (
        {"syr2k": launches["syr2k"] + launches["trailing_update"], "panel_qr": panel_launches["panel_qr"]},
        {"syr2k": device_launches["syr2k"] + device_launches["trailing_update"],
         "panel_qr": cuda_lib.device_launch_counts()["panel_qr"]},
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"phase 1 card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"TF32 off for matmul and cuDNN")
    t0 = time.perf_counter()
    paths = cuda_lib.build()
    for name in paths:
        cuda_lib.library(name)
    print(f"phase 1 built and loaded {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name in paths:
        log = (cuda_lib.build_dir() / f"{name}.ptxas.txt")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line:
                    print(f"phase 1 ptxas {name}: {line.strip()}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = phase_kernels(torch, gen)
    launches, device_launches = phase_main_path(torch, gen)
    phase_inverse_root(torch, gen)
    unfused, unfused_device = phase_unfused(torch, gen)
    launches.update(unfused)
    device_launches.update(unfused_device)

    # Kernel D serves two registry ops (syr2k, trailing_update); its launches
    # are the sum of both counters over the unfused plan(A) run.
    meta = {
        "fused_panel_update": ("src/repro_torch/csrc/fused_panel.cu", "src/repro/kernels/fused_panel.py:136"),
        "bulge_wavefront": ("src/repro_torch/csrc/bulge.cu", "src/repro/kernels/bulge.py:128"),
        "backtransform_wy": ("src/repro_torch/csrc/backtransform.cu", "src/repro/kernels/backtransform.py:67"),
        "syr2k": ("src/repro_torch/csrc/syr2k.cu", "src/repro/kernels/syr2k.py:74"),
        "panel_qr": ("src/repro_torch/csrc/panel.cu", "src/repro/kernels/panel.py:107"),
    }
    kernels = []
    for name, (source, replaces) in meta.items():
        row = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches[name], "device_launches": device_launches[name]}
        row.update(rows[name])
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
