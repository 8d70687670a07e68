#!/usr/bin/env python3
"""Time kernel A (``csrc/fused_panel.cu``) of a checkout, and check that it
repeats itself bit for bit.

    python3 scripts/kernel_a_compare.py [CHECKOUT]   # default: this checkout; needs one card

Builds only CHECKOUT's kernel A (into CHECKOUT/build) and prints, beside the
card's name and power limit:

* one call at the first block of the n = 4096 main path (m = 4096, w = nb,
  b from the ``cuda`` blocking row) against the plain version;
* the 16 calls of one n = 4096 solve, each on the trailing view the
  previous one left;
* the calls of one ``plan(128, EvdConfig(b=8, nb=64))`` solve, Shampoo's
  block, each a separate matrix's worth of launches;
* whether two calls on one input give the same bits.

Times are CUDA-event means after a warm-up, with this checkout's
``chip_smoke.cuda_ms`` (a spin kernel keeps host work out of the window),
so two checkouts are timed alike.  To hold a change against its parent,
unpack the parent with ``git archive`` into ``build/parent`` and run parent,
change, change, parent in one call, each as its own process.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_a_compare: no CUDA device", file=sys.stderr)
        return 2
    checkout = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT
    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    sys.path.insert(0, str(checkout / "src"))
    from repro_torch.core.band_reduction import build_stage_schedule
    from repro_torch.kernels import cuda_lib, ref
    from repro_torch.kernels.fused_panel import fused_panel_update_cuda
    from repro_torch.solver import resolve_blocking

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_lib.build(["fused_panel"])
    gen = torch.Generator(device="cuda").manual_seed(here.SEED)
    out = {"checkout": str(checkout), "card": here.card_line()}
    for n, b, nb in ((4096, None, None), (128, 8, 64)):
        dec = resolve_blocking(n, b=b, nb=nb, device_type="cuda")
        b, nb = dec.b, dec.nb
        A = torch.randn((n, n), generator=gen, device="cuda")
        A = A + A.T
        entries = build_stage_schedule(n, b, nb).entries
        w = entries[0].w
        Bk, Vk, Tk = fused_panel_update_cuda(A.clone(), b, w)
        Bp, Vp, Tp = ref.fused_panel_update_ref(A.clone(), b, w)
        err = max(here.rel_err(Bk, Bp), here.rel_err(Vk, Vp), here.rel_err(Tk, Tp))
        runs = [fused_panel_update_cuda(A.clone(), b, w) for _ in range(2)]
        same = all(torch.equal(x, y) for x, y in zip(*runs))
        reps = 5 if n > 1024 else 50
        one_ms = here.cuda_ms(torch, lambda B: fused_panel_update_cuda(B, b, w), reps, lambda: (A.clone(),))
        solve_ms = here.cuda_ms(
            torch, lambda B: [fused_panel_update_cuda(B[e.ci:, e.ci:], b, e.w) for e in entries],
            3 if n > 1024 else 50, lambda: (A.clone(),))
        row = dict(n=n, b=b, nb=nb, m=entries[0].m, w=w, rel_err=err, bitwise_repeat=same,
                   one_call_ms=one_ms, calls=len(entries), solve_ms=solve_ms)
        print(f"kernel_a {checkout.name or checkout}: {row}")
        out[f"n{n}"] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
