#!/usr/bin/env python3
"""Time a checkout's batched solves and its kernels A–C per block at
several bucket sizes, on one card.

    python3 scripts/bucket_compare.py [CHECKOUT] [--label NAME]   # default: this checkout

Builds CHECKOUT's kernels (into CHECKOUT/build) and prints, beside the
card's name and power limit, one JSON object a line:

* ``refresh_6a``: chip_smoke.py phase 6a's bucket, 1536 Shampoo blocks of
  128 (G G^T / 256 + 1e-3 I, seeded), ``EvdConfig(b=8, nb=64)``: the
  executor's stages as an eigh run (ms, device time between the CUDA
  events of the checkout's spans, ``repro_torch.backend.trace``; null
  for a checkout without them), the
  ``solve_many(op="inverse_pth_root")`` wall time and its kernel launches;
* ``refresh_8``: phase 8's refresh shapes, 2 ``solve_many`` buckets of
  6192 blocks of 128 (synthetic statistics as above, not trained ones):
  the stages of both buckets and the Rayleigh-Ritz root, summed, and the
  launches;
* ``kernels``: the device time (CUDA events behind a spin kernel, this
  checkout's ``chip_smoke.cuda_ms``) a block of kernel A (the two DBR
  blocks of a 128 solve), B (with the log) and C, at buckets of 1, 64 and
  1536 blocks, through the checkout's launchers: one call a bucket where
  they take a bucket, else one call a block, as that checkout's
  ``solve_many`` runs them (a loop of calls is timed with its host work
  where that outlasts the spin).

A checkout's stages swing by about 25 % from run to run (the plain stages
are host-bound), so two checkouts are compared within one call (a
checkout older than the recorder's spans reports no stages): unpack the
parent with ``git archive`` into ``build/parent`` and run parent, change,
change, parent, each as its own process.  With ``--out DIR`` each record
is also written to ``DIR/<label>.json``.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N, B6A, B8, BUCKETS = 128, 1536, 6192, (1, 64, 1536)


def _stats(torch, gen, count):
    G = torch.randn((count, N, 2 * N), generator=gen, device="cuda")
    return G @ G.mT / (2 * N) + 1e-3 * torch.eye(N, device="cuda")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bucket_compare: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", nargs="?", default=str(ROOT))
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    checkout = Path(args.checkout).resolve()
    label = args.label or checkout.name
    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    sys.path.insert(0, str(checkout / "src"))
    from repro_torch.core.backtransform import sweep_major_log
    from repro_torch.core.band_reduction import band_reduce, build_stage_schedule
    from repro_torch.kernels import cuda_lib, limits
    from repro_torch.kernels.backtransform import backtransform_wy_cuda
    from repro_torch.kernels.bulge import bulge_wavefront_cuda
    from repro_torch.kernels.fused_panel import fused_panel_update_cuda
    from repro_torch.backend import trace
    from repro_torch.solver import EvdConfig, batch_plan, solve_many

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_lib.build()
    batched = hasattr(limits, "bucket_chunk")  # the checkout's launchers take a bucket
    gen = torch.Generator(device="cuda").manual_seed(here.SEED)
    cfg = EvdConfig(b=8, nb=64)
    card = here.card_line()
    records = []

    def emit(rec):
        rec = dict(label=label, checkout=str(checkout), card=card, bucket_launchers=batched, **rec)
        print(json.dumps(rec), flush=True)
        records.append(rec)

    spans = hasattr(trace, "recording")  # the checkout records its stages' spans

    def stages_of(fn):
        """``fn()``'s stages, ms summed by stage (the executor's, the root's)."""
        with trace.recording() if spans else contextlib.nullcontext():
            fn()
        if not spans:
            return None
        return {k: v for k, v in here.stage_ms(trace.session()).items() if k != "q2_regroup"}

    # Phase 6a's bucket: stages as an eigh run, then the refresh's wall time.
    S = _stats(torch, gen, B6A)
    batch_plan(N, 2, torch.float32, cfg)(S[:2])  # warm the plan and the kernels
    eigh_stages = stages_of(lambda: batch_plan(N, B6A, torch.float32, cfg)(S))
    cuda_lib.reset_launch_counts()
    ms = here.wall_ms(torch, lambda: solve_many(S, cfg, op="inverse_pth_root", p=4, eps=1e-6))
    emit(dict(cell="refresh_6a", blocks=B6A, stages_ms=eigh_stages,
              stages_total_ms=None if eigh_stages is None else sum(eigh_stages.values()),
              inverse_root_ms=ms, launches=cuda_lib.launch_counts(),
              device_launches=cuda_lib.device_launch_counts()))
    del S

    # Phase 8's refresh shapes: two buckets of 6192 and the roots.
    sides = [_stats(torch, gen, B8) for _ in range(2)]
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    stages = stages_of(lambda: [solve_many(Sx, cfg, op="inverse_pth_root", p=4, eps=1e-6) for Sx in sides])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    emit(dict(cell="refresh_8", blocks=2 * B8, stages_ms=stages,
              stages_total_ms=None if stages is None else sum(stages.values()),
              wall_ms=wall, launches=cuda_lib.launch_counts(), device_launches=cuda_lib.device_launch_counts()))
    del sides

    # Kernels A, B, C a block at buckets of 1, 64, 1536.
    S = _stats(torch, gen, max(BUCKETS))
    A0 = 0.5 * (S + S.mT)
    entries = build_stage_schedule(N, cfg.b, cfg.nb).entries
    bands = torch.stack([band_reduce(A0[i], cfg.b, cfg.nb) for i in range(max(BUCKETS))])
    logs = [bulge_wavefront_cuda(bands[i], cfg.b, return_log=True)[1] for i in range(max(BUCKETS))]
    sw = [sweep_major_log(lg) for lg in logs]
    vs, taus = torch.stack([v for v, _ in sw]), torch.stack([t for _, t in sw])
    X = torch.randn((max(BUCKETS), N, N), generator=gen, device="cuda")
    out = {}
    for k in BUCKETS:
        if batched:
            a = lambda M: [fused_panel_update_cuda(M[:, e.ci:, e.ci:], cfg.b, e.w) for e in entries]  # noqa: E731
            b = lambda: bulge_wavefront_cuda(bands[:k], cfg.b, return_log=True)  # noqa: E731
            c = lambda: backtransform_wy_cuda(X[:k], vs[:k], taus[:k], b=cfg.b)  # noqa: E731
        else:
            a = lambda M: [fused_panel_update_cuda(M[i, e.ci:, e.ci:], cfg.b, e.w)  # noqa: E731
                           for i in range(M.shape[0]) for e in entries]
            b = lambda: [bulge_wavefront_cuda(bands[i], cfg.b, return_log=True) for i in range(k)]  # noqa: E731
            c = lambda: [backtransform_wy_cuda(X[i], vs[i], taus[i], b=cfg.b) for i in range(k)]  # noqa: E731
        reps = 5 if k < 1536 else 2
        out[k] = dict(
            A=here.cuda_ms(torch, a, reps, lambda: (A0[:k].clone(),)) / k,
            B=here.cuda_ms(torch, b, reps) / k,
            C=here.cuda_ms(torch, c, reps) / k,
        )
    emit(dict(cell="kernels", ms_per_block=out))
    if args.out:
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / f"{label}.json").write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
