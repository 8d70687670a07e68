#!/usr/bin/env python3
"""The readings the check's limits are set from, for one cell at its own
size on this machine's card, in one process.

    python3 evdbench/control.py --workload NAME --program-seeds 1-12 --control-seeds 1-3 \
        [--seconds 1] [--out DIR]

Each seed is one whole run of the cell (``harness.run_cell``) with a short
window of at least as many calls as a run checks: for a program seed with
the cell's own entry, for a control seed with ``entries/sytrd_tf32`` in its
place, the plain reference one precision below the configuration's float32
(TF32).  Each prints one JSON line, on standard output and under ``--out``:
``correct`` as the run decided it and the numbers compared.  A limit lies
between the largest program reading and the smallest control reading, and
every control run has to come out not correct.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CONTROL_ENTRY = "sytrd_tf32"


def seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    from evdbench import harness

    out = open(Path(args.out) / f"control_{args.workload}.jsonl", "a") if args.out else None
    for side, entry, seed_list in (("program", None, seeds(args.program_seeds)),
                                   ("control", CONTROL_ENTRY, seeds(args.control_seeds))):
        for seed in seed_list:
            t = time.perf_counter()
            try:
                result, checks = harness.run_cell(args.workload, seed, args.seconds, False, entry=entry)
            except harness.NoCard as exc:
                print(f"control: {exc}", file=sys.stderr)
                return 2
            line = json.dumps({"workload": args.workload, "side": side, "seed": seed,
                               "correct": result["correct"], "calls": result["attempted"],
                               "numbers": result["readings"], "checks": checks, "card": result["card"],
                               "seconds": time.perf_counter() - t})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
