#!/usr/bin/env python3
"""Run chip_smoke.py's kernel phase (2) and unfused phase (5) of a checkout.

    python3 scripts/chip_compare.py [CHECKOUT]    # default: this checkout; needs one card

To hold a change against its parent on one card, unpack the parent with
``git archive`` into a git-ignored directory (``build/parent``) and run
parent, change, change, parent in one call.  Each run imports CHECKOUT's
own ``chip_smoke.py`` and ``src/repro_torch`` (its kernels build into
CHECKOUT/build), but times kernels with this checkout's
``chip_smoke.cuda_ms``, so both sides are timed alike.  Prints the card's
name and power limit, the phases' lines and the kernels' JSON.
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
        print("chip_compare: no CUDA device", file=sys.stderr)
        return 2
    checkout = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT
    spec = importlib.util.spec_from_file_location("chip_smoke_here", ROOT / "chip_smoke.py")
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    sys.path[:0] = [str(checkout / "src"), str(checkout)]
    import chip_smoke as target

    target.cuda_ms = here.cuda_ms
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"chip_compare {checkout}: {target.card_line()}")
    gen = torch.Generator(device="cuda").manual_seed(target.SEED)
    rows = target.phase_kernels(torch, gen)
    target.phase_unfused(torch, gen)
    print(json.dumps({"checkout": str(checkout), "kernels": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
