#!/usr/bin/env python3
"""What compressing loops of identical trips buys a CPU dry-run.

    PYTHONPATH=src python scripts/trace_compress.py [--full]

Runs ``run_cell("llama3.2-3b", "train_4k", optimizer_name="shampoo",
device="cpu")`` on the smoke cell of tests/test_torch_dryrun.py (llama's
smoke config, 1 layer, (2, 2)) and, with ``--full``, on the full-size cell
(the (16, 16) mesh): once as the package runs it, and once with the plain
chase's wavefronts (``core/bulge_chasing.py``) and the plain
back-transform's sweeps (``core/backtransform.py``) run trip by trip on the
fake tensors, as they would without ``trace.repeated``.  Prints each run's
trace seconds and its counts (FLOPs, HBM bytes, peak estimate), which must
be the same both ways.  On the card those two loops are kernels B and C.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

CELLS = {"smoke": dict(mesh_override=(2, 2), smoke=True, overrides=dict(n_layers=1),
                       shape_overrides=dict(batch=4, seq=32)),
         "full": {}}


@contextlib.contextmanager
def _every_trip(n, like):
    yield range(n)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--full", action="store_true", help="also the full-size cell (~3 min)")
    args = p.parse_args()

    import torch

    import repro_torch.core.backtransform as bt
    import repro_torch.core.bulge_chasing as bc
    import repro_torch.launch.dryrun as dr

    torch.set_num_threads(1)
    compressed = {mod: mod.repeated for mod in (bc, bt)}
    counts = {}
    for name in ["smoke"] + (["full"] if args.full else []):
        for mode in ("compressed", "every trip"):
            for mod, fn in compressed.items():
                mod.repeated = fn if mode == "compressed" else _every_trip
            t0 = time.perf_counter()
            rec = dr.run_cell("llama3.2-3b", "train_4k", optimizer_name="shampoo", device="cpu", quiet=True,
                              top=0, **CELLS[name])
            wall = time.perf_counter() - t0
            got = (rec["walk"]["flops_per_device"], rec["walk"]["hbm_bytes_per_device"],
                   rec["memory"]["peak_estimate_bytes"])
            counts.setdefault(name, set()).add(got)
            print(f"{name} cell, plain chase and back-transform {mode}: trace {rec['trace_s']} s ({wall:.1f} s "
                  f"with set-up); FLOPs {got[0]:.6e}, HBM bytes {got[1]:.6e}, peak estimate {got[2]}", flush=True)
        for mod, fn in compressed.items():
            mod.repeated = fn
    same = all(len(v) == 1 for v in counts.values())
    print(f"counts the same both ways: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
