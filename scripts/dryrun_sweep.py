#!/usr/bin/env python3
"""The dry-run of every (arch x shape) cell, one process a cell, several at
once, and a table of the records.

    python3 scripts/dryrun_sweep.py [--jobs 8] [--device cuda] [--out experiments/dryrun_sweep]

Each cell runs ``python -m repro_torch.launch.dryrun --arch A --shape S``
(its JSON record in ``--out``), ``--jobs`` at a time, each process with
its own fake world and fake tensors of ``--device`` (default ``cuda``,
which needs a card; ``cpu`` without one).  Prints one markdown row a cell: GiB
of peak estimate, GFLOP and collective MiB a device, the dominant term,
``roofline_fraction`` and ``trace_s``, or the status; and the sweep's wall
time.
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
    from repro_torch.launch.specs import all_cells

    p = argparse.ArgumentParser()
    p.add_argument("--jobs", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="experiments/dryrun_sweep")
    p.add_argument("--timeout", type=float, default=1200.0, help="seconds a cell")
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    cells = [(a, s) for a, s, _ in all_cells()]
    pod = "1pod"
    t0 = time.perf_counter()
    with ThreadPoolExecutor(args.jobs) as pool:
        rcs = list(pool.map(lambda c: _run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", c[0], "--shape", c[1], "--device",
             args.device, "--out", args.out], env, args.timeout), cells))
    wall = time.perf_counter() - t0
    print("| arch | shape | GiB/device | GFLOP/device | coll MiB/device | dominant | roofline_fraction | trace_s |")
    print("|---|---|---|---|---|---|---|---|")
    for (arch, shape), rc in zip(cells, rcs):
        path = Path(args.out) / f"{arch}_{shape}_{pod}.json"
        rec = json.loads(path.read_text()) if path.exists() and rc != "timeout" else {"status": f"not run ({rc})"}
        if rec["status"] == "ok":
            rf = rec["roofline"]
            print(f"| {arch} | {shape} | {rec['memory']['peak_estimate_bytes'] / 2**30:.2f} | "
                  f"{rec['walk']['flops_per_device'] / 1e9:.1f} | {rec['collectives']['total_bytes'] / 2**20:.1f} | "
                  f"{rf['dominant']} | {rf['roofline_fraction']:.4f} | {rec['trace_s']} |")
        else:
            print(f"| {arch} | {shape} | {rec['status']}: {rec.get('reason') or rec.get('error', '')} |||||||")
    print(f"sweep of {len(cells)} cells (1-pod, {args.jobs} at a time) took {wall:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
