#!/usr/bin/env python3
"""Which collectives take CUDA tensors on a gloo group whose ranks share one card.

    python3 scripts/gloo_cuda_check.py      # from the root of a checkout; needs a card

Several ranks on one card cannot use NCCL (it refuses two ranks on one
device), so the port's multi-device paths run them on gloo.  This script
starts four ranks on the card through ``repro_torch.parallel.run_ranks``
and checks, on CUDA tensors, c10d ``all_gather``, ``all_gather_into_tensor``
and ``all_reduce`` (float32, int32 and bfloat16; ``all_gather`` in
bfloat16 too) for the right values, and the autograd collectives of
``repro_torch.parallel.comm`` that the sharded train step uses (on a (2, 2)
mesh: ``all_reduce``, ``copy_to``, ``all_gather`` with either backward,
``reduce_scatter``, ``split``), forward and backward, against their
values computed by hand; and times
``repro_torch.parallel.all_gather_rows`` of one (3840, 960) float32 block a
rank (the largest trailing block of ``dist_band_reduce`` at n = 4096).
Then, in a world of its own (a crash ends only that world), it calls
``DTensor.full_tensor()`` on a row-sharded CUDA DTensor, which the port
never calls (``repro_torch.parallel.comm.full_tensor`` gathers by
``all_gather`` on every backend), and reports how the world ended; likewise gloo's ``reduce_scatter_tensor``
on CUDA tensors, which ``comm.reduce_scatter`` calls on every backend (a
failure there fails the script).  Prints the card's name and power limit
first.
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
    for dtype in (torch.float32, torch.int32, torch.bfloat16):
        y = torch.full((3,), rank + 1, dtype=dtype, device=dev)
        dist.all_reduce(y)
        out[f"all_reduce {dtype}"] = bool((y == world * (world + 1) // 2).all())
    xb = x.to(torch.bfloat16)
    parts = [torch.empty_like(xb) for _ in range(world)]
    dist.all_gather(parts, xb)
    out["all_gather torch.bfloat16"] = bool(torch.equal(torch.cat(parts)[:, 0].float(), want))
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


def _autograd():
    """The step's autograd collectives on a (2, 2) mesh, each rank's input
    ``x = (rank + 1) * [0, 1, 2, 3]`` in bfloat16 and float32: forward and
    gradient of ``sum(y * w)`` with ``w`` the model index + 1, by hand."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import make_local_mesh
    from repro_torch.parallel import comm

    mesh = make_local_mesh(2)
    rank = dist.get_rank()
    j = rank % 2  # model index; the model group is {rank - j, rank - j + 1}
    peers = [rank - j + 1, rank - j + 2]  # (rank + 1) of each model peer
    base = torch.arange(4.0, device="cuda")
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        def run(fn):
            x = ((rank + 1) * base).to(dtype).requires_grad_(True)
            y = fn(x)
            (y.float() * (j + 1)).sum().backward()
            return y.float(), x.grad.float()

        tot = sum(peers) * base
        y, g = run(lambda x: comm.all_reduce(x, mesh, "model"))
        ok = torch.equal(y, tot) and torch.equal(g, torch.full_like(base, j + 1))
        y, g = run(lambda x: comm.copy_to(x, mesh, "model"))
        ok &= torch.equal(y, (rank + 1) * base) and torch.equal(g, torch.full_like(base, 3.0))
        y, g = run(lambda x: comm.all_gather(x, mesh, "model", 0))
        ok &= torch.equal(y, torch.cat([p * base for p in peers])) and torch.equal(g, torch.full_like(base, 3.0))
        y, g = run(lambda x: comm.all_gather(x, mesh, "model", 0, grad="slice"))
        ok &= torch.equal(g, torch.full_like(base, j + 1))
        y, g = run(lambda x: comm.reduce_scatter(x, mesh, "model", 0))
        rows = torch.tensor([1.0, 1.0, 2.0, 2.0], device="cuda")  # each model rank's w on its own rows
        ok &= torch.equal(y, tot[2 * j:2 * j + 2]) and torch.equal(g, rows)
        y, g = run(lambda x: comm.split(x, mesh, "model", 0))
        ok &= torch.equal(y, ((rank + 1) * base)[2 * j:2 * j + 2]) and torch.equal(g, rows)
        out[f"autograd collectives {dtype}"] = bool(ok)
    return out


def _reduce_scatter():
    import torch
    import torch.distributed as dist

    n = dist.get_world_size()
    x = torch.full((n, 3), float(dist.get_rank() + 1), device="cuda")
    y = torch.empty((1, 3), device="cuda")
    dist.reduce_scatter_tensor(y, x)
    return bool((y == n * (n + 1) / 2).all())


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
    grads = run_ranks(_autograd, RANKS, backend="gloo", device_type="cuda", timeout_s=300)
    for name in grads[0]:
        print(f"gloo, a (2, 2) mesh on one card: repro_torch.parallel.comm {name} (forward and backward) right "
              f"on every rank: {all(r[name] for r in grads)}")
    mb = ROWS * COLS * 4 * RANKS / 2**20
    print(f"all_gather_rows of ({ROWS}, {COLS}) float32 a rank ({mb:.0f} MiB gathered on each rank): "
          f"{[round(r['gather_ms'], 1) for r in res]} ms per rank (mean of {REPS})")
    try:
        scattered = all(run_ranks(_reduce_scatter, RANKS, backend="gloo", device_type="cuda", timeout_s=120))
        print(f"reduce_scatter_tensor on gloo with CUDA tensors: right on every rank: {scattered}")
    except RuntimeError as e:
        scattered = False
        print(f"reduce_scatter_tensor on gloo with CUDA tensors failed: "
              f"{' | '.join(line for line in str(e).splitlines() if line.startswith('rank'))[:400]}")
    try:
        got = run_ranks(_full_tensor, 2, backend="gloo", device_type="cuda", timeout_s=120)
        print(f"DTensor.full_tensor() on gloo with CUDA tensors: returned {got}")
    except RuntimeError as e:
        print(f"DTensor.full_tensor() on gloo with CUDA tensors failed: "
              f"{' | '.join(line for line in str(e).splitlines() if line.startswith('rank'))}")
    ok = all(all(v for k, v in r.items() if k != "gather_ms") for r in res) and all(all(r.values()) for r in grads)
    ok &= scattered
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
