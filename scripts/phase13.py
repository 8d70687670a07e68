#!/usr/bin/env python3
"""chip_smoke.py phase 13 alone: tensor parallelism of the mixers, sharded
serving and the dry-run held against real steps.

    python3 scripts/phase13.py      # from the root of a checkout; needs a card

Four gloo ranks share the card on a (2, 2) ("data", "model") mesh and run
``chip_smoke._mixer_rank`` (phase 13 (a) and the real half of (c)); then
this process runs ``chip_smoke.phase_dryrun`` ((a)'s gates, (b)'s
dry-runs of the production worlds, (c)).  The kernels are built first:
the ranks also run phase 14 (b)'s real Shampoo steps, whose gates
``scripts/phase14.py`` holds.  Prints the card's name and power limit
first and exits 0 only if every gate passes.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _rank():
    import torch

    import chip_smoke as cs
    from repro_torch.launch import make_local_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return cs._mixer_rank(make_local_mesh(2))


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.parallel import run_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import cuda_lib

    print(cs.card_line())
    cuda_lib.build()
    t0 = time.perf_counter()
    mixers = run_ranks(_rank, cs.SHARD_RANKS, backend="gloo", device_type="cuda", timeout_s=900)
    world_s = time.perf_counter() - t0 - max(m["s"] for m in mixers)
    cs.phase_dryrun(torch, mixers, world_s)
    print(f"phase 13 alone took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
