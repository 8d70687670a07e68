#!/usr/bin/env python3
"""chip_smoke.py phase 14 alone: kernels A-E as ``repro_torch`` operators
and the dry-run's Shampoo option.

    python3 scripts/phase14.py      # from the root of a checkout; needs a card

Builds the kernels, makes phase 2's inputs (the n = 4096 main path's first
kernel-A block, its band and chase log, an (n, n) panel, the first trailing
update's operands and the largest panel, from the seed), runs the smoke
Shampoo cell for real on four gloo ranks sharing the card
(``chip_smoke._shampoo_rank``), then ``chip_smoke.phase_operators``.
Phase 6a is not run, so (f) prints nan.  Prints the card's name and power
limit first and exits 0 only if every gate passes.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def kernel_inputs(torch, gen) -> dict:
    """Phase 2's inputs of each kernel, at its shapes."""
    import chip_smoke as cs
    from repro_torch.core.backtransform import sweep_major_log
    from repro_torch.core.band_reduction import band_reduce
    from repro_torch.kernels.bulge import bulge_wavefront_cuda
    from repro_torch.solver import resolve_blocking

    n = cs.N_MAIN
    dec = resolve_blocking(n, device_type="cuda")
    b, w = dec.b, dec.nb
    A = torch.randn((n, n), generator=gen, device="cuda")
    A = A + A.T
    band = band_reduce(A, b, dec.nb)
    _, log = bulge_wavefront_cuda(band, b, return_log=True)
    vs, taus = sweep_major_log(log)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    return dict(A=A, b=b, w=w, band=band, X=rand(n, n), vs=vs, taus=taus, C=A[w:, w:], Y=rand(n - w, w),
                Z=rand(n - w, w), P=rand(n - b, b))


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import cuda_lib
    from repro_torch.parallel import run_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card_line())
    t0 = time.perf_counter()
    cuda_lib.build()
    print(f"phase 14 alone: built the kernels in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    inputs = kernel_inputs(torch, gen)
    ranks = run_ranks(cs._shampoo_rank, cs.SHARD_RANKS, backend="gloo", device_type="cuda", timeout_s=900)
    cs.phase_operators(torch, gen, inputs, ranks, float("nan"))
    print(f"phase 14 alone took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
