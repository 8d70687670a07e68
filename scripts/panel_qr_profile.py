#!/usr/bin/env python3
"""Kernel E (the standalone panel QR) where band_reduce runs it, for one checkout.

    python3 scripts/panel_qr_profile.py [CHECKOUT]   # default: this checkout; needs one card

Imports CHECKOUT's ``src/repro_torch`` (its kernels build into
CHECKOUT/build) and, at n = 4096 on a seeded random symmetric matrix:

- times ``band_reduce(A, 8, 256, panel_method="kernel")`` on the host clock
  (three calls after a warm-up, each closed by a synchronize);
- traces one more call with ``torch.profiler`` and sums the device time and
  the CUDA launches of the kernels whose name starts with ``panel_qr``, the
  device time of everything else the call ran on the card, and the
  device's idle share against the fastest untraced call;
- times ``panel_qr_cuda`` on one panel per height m (b = 8): its device
  time (calls back to back between two CUDA events behind a ~25 ms spin
  kernel, as chip_smoke.py's ``cuda_ms``) and its time per call with the
  launcher's host work (200 calls back to back on the host clock, closed by
  one synchronize).

To hold a change against its parent on one card, unpack the parent with
``git archive`` into a git-ignored directory (``build/parent``) and run
parent, change, change, parent in one call, each in its own process (one
profiler session per process records device time).  Prints the card's name
and power limit, the lines above and one JSON line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N, B, NB = 4096, 8, 256
HEIGHTS = (4088, 2048, 1024, 256, 64, 8)
HOST_CALLS = 200
SPIN_CYCLES = 50_000_000  # ~25 ms at the H100's ~2 GHz clock


def device_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("panel_qr_profile: no CUDA device", file=sys.stderr)
        return 2
    checkout = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT
    sys.path.insert(0, str(checkout / "src"))
    from repro_torch.core.band_reduction import band_reduce, build_stage_schedule
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.panel import panel_qr_cuda

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"panel_qr_profile {checkout}: {card}")
    cuda_lib.build(["panel", "syr2k"])
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn((N, N), generator=gen, device="cuda")
    A = A + A.T
    panels = build_stage_schedule(N, B, NB).num_panels

    def run():
        return band_reduce(A, B, NB, panel_method="kernel")

    run()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # Device-side events only (kernels, copies, sets): an operator's entry
    # also carries its kernels' time, which would count them twice.
    e_us = e_count = other_us = 0
    others = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU:
            continue
        us = getattr(ev, "device_time_total", 0) or getattr(ev, "cuda_time_total", 0)
        if us <= 0:
            continue
        name = ev.key.removeprefix("void ").replace("(anonymous namespace)::", "")
        if name.startswith("panel_qr"):
            e_us += us
            e_count += ev.count
        else:
            other_us += us
            others.append((us, ev.count, name.split("(")[0][:48]))
    print(f'band_reduce(A, {B}, {NB}, panel_method="kernel") n={N}: wall ms '
          + " / ".join(f"{w:.1f}" for w in walls) + f"; device busy {(e_us + other_us) / 1e3:.3f} ms "
          f"of the traced call, {1 - (e_us + other_us) / 1e3 / min(walls):.1%} idle against the "
          f"fastest untraced wall")
    print(f"traced call: {e_count} CUDA launches of panel_qr* ({panels} panels), device time "
          f"{e_us / 1e3:.3f} ms ({e_us / max(e_count, 1):.2f} us a launch); the rest of the "
          f"call's device time {other_us / 1e3:.3f} ms, most: " + "; ".join(
              f"{name} {us / 1e3:.3f} ms x{cnt}" for us, cnt, name in sorted(others, reverse=True)[:6]))
    per_m = {}
    for m in HEIGHTS:
        P = torch.randn((m, B), generator=gen, device="cuda")
        dev = device_ms(torch, lambda: panel_qr_cuda(P), 50)
        host = host_ms(torch, lambda: panel_qr_cuda(P), HOST_CALLS)
        per_m[m] = dict(device_ms=dev, host_inclusive_ms=host)
        print(f"panel_qr_cuda (m, b)=({m}, {B}): device ms={dev:.4f}, with the launcher's host "
              f"work ms={host:.4f} a call")
    print(json.dumps({"checkout": str(checkout), "card": card, "band_reduce_wall_ms": walls,
                      "traced_panel_qr_launches": e_count, "traced_panel_qr_device_ms": e_us / 1e3,
                      "traced_other_device_ms": other_us / 1e3, "panels": panels,
                      "idle_share_vs_fastest_wall": 1 - (e_us + other_us) / 1e3 / min(walls),
                      "panel_qr_cuda": per_m}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
