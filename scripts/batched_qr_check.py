#!/usr/bin/env python3
"""CUDA's batched QR on matrices with repeated columns, and the Shampoo
roots of rank-deficient statistics blocks in a bucket.

    python3 scripts/batched_qr_check.py      # from the root of a checkout; needs one card

Inverse iteration gives a cluster's lanes the same start vector and one of
8 shift offsets, so the matrix its QR polish factors has exactly repeated
columns (a Shampoo statistics block of rank 4 in 128 has a cluster of 124
zeros).  Prints, beside the card's name and power limit:

* max|Q^T Q - I| of ``torch.linalg.qr`` on a stack of 8 such (128, 128)
  matrices (4 random columns, then 8 random columns repeated), batched and
  one matrix at a time, and of ``repro_torch.core.tridiag_eig._qr``;
* the inverse 4th roots of 24 rank-4 blocks (a (4, 32) gradient padded to
  128, G G^T / 100) in one ``solve_many`` bucket beside 24 full-rank ones,
  with the QR polish as it is and with plain batched ``torch.linalg.qr``
  in its place, and the same rank-4 blocks through ``plan(128)`` one at a
  time: the largest error relative to the float64 formula (phase 8's root
  gate).
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("batched_qr_check: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.core.tridiag_eig import _qr
    from repro_torch.kernels import cuda_lib
    from repro_torch.solver import EvdConfig, plan, solve_many

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    for name in cuda_lib.build():
        cuda_lib.library(name)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def orth(Q):
        return float((Q.mT @ Q - torch.eye(Q.shape[-1], device="cuda")).abs().max())

    X = torch.empty((8, 128, 128), device="cuda")
    X[:, :, :4] = torch.randn((8, 128, 4), generator=gen, device="cuda")
    reps = torch.randn((8, 128, 8), generator=gen, device="cuda")
    X[:, :, 4:] = reps.repeat(1, 1, 16)[:, :, :124]
    batched = torch.linalg.qr(X).Q
    single = torch.stack([torch.linalg.qr(x).Q for x in X])
    print(f"max|Q^T Q - I| on 8 (128, 128) matrices with repeated columns: batched torch.linalg.qr "
          f"{orth(batched):.3e}, one matrix at a time {orth(single):.3e}, tridiag_eig._qr {orth(_qr(X)[0]):.3e}")

    cfg = EvdConfig(b=8, nb=64)
    G = torch.zeros((48, 128, 128), device="cuda")
    G[:24, :4, :32] = torch.randn((24, 4, 32), generator=gen, device="cuda") * 1e-4
    G[24:] = torch.randn((24, 128, 128), generator=gen, device="cuda") * 1e-4
    S = 0.01 * G @ G.mT
    S = 0.5 * (S + S.mT)
    idx = torch.arange(24, device="cuda")
    bucket = solve_many(S, cfg, op="inverse_pth_root", p=4, eps=1e-6)
    one = torch.stack([plan(128, torch.float32, cfg).inverse_pth_root(s, 4) for s in S[:24]])
    e_bucket, _, lib = cs.root_errors(torch, S, bucket, idx, 1e-6)
    e_one, _, _ = cs.root_errors(torch, S[:24], one, idx, 1e-6)
    e_full, _, _ = cs.root_errors(torch, S, bucket, idx + 24, 1e-6)
    tridiag_eig = sys.modules["repro_torch.core.tridiag_eig"]
    tridiag_eig._qr = torch.linalg.qr
    try:
        plain = solve_many(S, cfg, op="inverse_pth_root", p=4, eps=1e-6)
    finally:
        tridiag_eig._qr = _qr
    e_plain, _, _ = cs.root_errors(torch, S, plain, idx, 1e-6)
    print(f"inverse 4th roots of 24 rank-4 blocks vs float64: in a bucket of 48 {float(e_bucket.max()):.3e} "
          f"(with plain batched torch.linalg.qr in the polish {float(e_plain.max()):.3e}), plan(128) one at a "
          f"time {float(e_one.max()):.3e}, float32 torch.linalg.eigh {float(lib.max()):.3e}; the bucket's 24 "
          f"full-rank blocks {float(e_full.max()):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
