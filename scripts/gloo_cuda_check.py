#!/usr/bin/env python3
"""Which collectives take CUDA tensors on a gloo group whose ranks share one card.

    python3 scripts/gloo_cuda_check.py      # from the root of a checkout; needs a card

Several ranks on one card cannot use NCCL (it refuses two ranks on one
device), so the port's multi-device paths run them on gloo.  This script
starts four ranks on the card through ``repro_torch.parallel.run_ranks``
and checks, on CUDA tensors, c10d ``all_gather``, ``all_gather_into_tensor``
and ``all_reduce`` (float32 and int32) for the right values, and times
``repro_torch.parallel.all_gather_rows`` of one (3840, 960) float32 block a
rank (the largest trailing block of ``dist_band_reduce`` at n = 4096).
Then, in a world of its own (a crash ends only that world), it calls
``DTensor.full_tensor()`` on a row-sharded CUDA DTensor, which the port
never calls (``repro_torch.parallel.comm.full_tensor`` gathers by
``all_gather`` on every backend), and reports how the world ended.  Prints the card's name and power limit first.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

RANKS = 4
ROWS, COLS = 3840, 3840 // RANKS
REPS = 3


def _collectives():
    import torch
    import torch.distributed as dist

    from repro_torch.parallel import all_gather_rows

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    x = torch.full((2, 3), float(rank), device=dev)
    want = torch.arange(world, dtype=torch.float32, device=dev).repeat_interleave(2)
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    out["all_gather"] = bool(torch.equal(torch.cat(parts)[:, 0], want))
    flat = torch.empty((2 * world, 3), device=dev)
    dist.all_gather_into_tensor(flat, x)
    out["all_gather_into_tensor"] = bool(torch.equal(flat[:, 0], want))
    for dtype in (torch.float32, torch.int32):
        y = torch.full((3,), rank + 1, dtype=dtype, device=dev)
        dist.all_reduce(y)
        out[f"all_reduce {dtype}"] = bool((y == world * (world + 1) // 2).all())
    block = torch.randn((ROWS, COLS), device=dev, generator=torch.Generator(device=dev).manual_seed(rank))
    group = dist.group.WORLD
    all_gather_rows(block, group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        full = all_gather_rows(block, group)
    torch.cuda.synchronize()
    out["gather_ms"] = (time.perf_counter() - t0) / REPS * 1e3
    ref = torch.randn((ROWS, COLS), device=dev, generator=torch.Generator(device=dev).manual_seed(world - 1))
    out["gather_right"] = bool(torch.equal(full[-ROWS:], ref))
    return out


def _full_tensor():
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    mesh = init_device_mesh("cuda", (dist.get_world_size(),), mesh_dim_names=("x",))
    x = torch.full((2, 3), float(dist.get_rank()), device="cuda")
    return DTensor.from_local(x, mesh, [Shard(0)], run_check=False).full_tensor()[:, 0].tolist()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda_check: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.parallel import run_ranks

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
    res = run_ranks(_collectives, RANKS, backend="gloo", device_type="cuda", timeout_s=300)
    for name in res[0]:
        if name != "gather_ms":
            print(f"gloo, {RANKS} ranks on one card, CUDA tensors: {name} right on every rank: "
                  f"{all(r[name] for r in res)}")
    mb = ROWS * COLS * 4 * RANKS / 2**20
    print(f"all_gather_rows of ({ROWS}, {COLS}) float32 a rank ({mb:.0f} MiB gathered on each rank): "
          f"{[round(r['gather_ms'], 1) for r in res]} ms per rank (mean of {REPS})")
    try:
        got = run_ranks(_full_tensor, 2, backend="gloo", device_type="cuda", timeout_s=120)
        print(f"DTensor.full_tensor() on gloo with CUDA tensors: returned {got}")
    except RuntimeError as e:
        print(f"DTensor.full_tensor() on gloo with CUDA tensors failed: "
              f"{' | '.join(line for line in str(e).splitlines() if line.startswith('rank'))}")
    return 0 if all(all(v for k, v in r.items() if k != "gather_ms") for r in res) else 1


if __name__ == "__main__":
    sys.exit(main())
