#!/usr/bin/env python3
"""The dry-run of every (arch x shape) cell, one process a cell, several at
once, and a table of the records.

    python3 scripts/dryrun_sweep.py [--jobs 8] [--device cuda] [--out experiments/dryrun_sweep]
    python3 scripts/dryrun_sweep.py --optimizer shampoo [--shampoo-sharded]   # the train cells

Each cell runs ``python -m repro_torch.launch.dryrun --arch A --shape S``
(its JSON record in ``--out``), ``--jobs`` at a time, each process with
its own fake world and fake tensors of ``--device`` (default ``cuda``,
which needs a card; ``cpu`` without one).  Prints one markdown row a cell: GiB
of peak estimate, GFLOP and collective MiB a device, the dominant term,
``roofline_fraction`` and ``trace_s``, or the status; and the sweep's wall
time.  With ``--optimizer shampoo`` only the train cells run (the others
take no optimizer), each row with the Shampoo state's GB a rank, the blocks
a side and rank 0's share of the refresh, and whether the cell fits one
80 GB card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]


def _run(cmd, env, timeout):
    try:
        return subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout).returncode
    except subprocess.TimeoutExpired:
        return "timeout"


def main() -> int:
    from repro_torch.launch.specs import SHAPES, all_cells

    p = argparse.ArgumentParser()
    p.add_argument("--jobs", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="experiments/dryrun_sweep")
    p.add_argument("--timeout", type=float, default=1200.0, help="seconds a cell")
    p.add_argument("--optimizer", default="adamw", choices=("adamw", "shampoo"))
    p.add_argument("--shampoo-sharded", action="store_true", help="split the refresh over every mesh axis")
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    shampoo = args.optimizer == "shampoo"
    cells = [(a, s) for a, s, _ in all_cells() if not shampoo or SHAPES[s]["kind"] == "train"]
    flags = ["--optimizer", args.optimizer] + (["--shampoo-sharded"] if args.shampoo_sharded else [])
    suffix = "" if not shampoo else "_shampoo" + ("_sharded" if args.shampoo_sharded else "")
    pod = "1pod"
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        rcs = list(pool.map(lambda c: _run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", c[0], "--shape", c[1], "--device",
             args.device, "--out", args.out, *flags], env, args.timeout), cells))
    wall = time.perf_counter() - t0
    extra = " Shampoo state GB | blocks a side | rank 0's blocks a side | fits 80 GB |" if shampoo else ""
    print("| arch | shape | GiB/device | GFLOP/device | coll MiB/device | dominant | roofline_fraction | trace_s |"
          + extra)
    print("|---|---|---|---|---|---|---|---|" + "---|" * extra.count("|"))
    for (arch, shape), rc in zip(cells, rcs):
        path = Path(args.out) / f"{arch}_{shape}_{pod}{suffix}.json"
        rec = json.loads(path.read_text()) if path.exists() and rc != "timeout" else {"status": f"not run ({rc})"}
        if rec["status"] == "ok":
            rf = rec["roofline"]
            row = (f"| {arch} | {shape} | {rec['memory']['peak_estimate_bytes'] / 2**30:.2f} | "
                   f"{rec['walk']['flops_per_device'] / 1e9:.1f} | {rec['collectives']['total_bytes'] / 2**20:.1f} | "
                   f"{rf['dominant']} | {rf['roofline_fraction']:.4f} | {rec['trace_s']} |")
            if shampoo:
                sh = rec["shampoo"]
                row += (f" {sum(sh['state_bytes'].values()) / 1e9:.2f} | {sh['blocks_per_side']} | "
                        f"{sh['rank0_blocks_per_side']} | {rec['memory']['peak_estimate_bytes'] <= 80e9} |")
            print(row)
        else:
            print(f"| {arch} | {shape} | {rec['status']}: {rec.get('reason') or rec.get('error', '')} |||||||")
    print(f"sweep of {len(cells)} cells (1-pod, {args.jobs} at a time, {args.optimizer}"
          f"{', refresh sharded' if args.shampoo_sharded else ''}) took {wall:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
