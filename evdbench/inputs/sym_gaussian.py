"""Dense random symmetric matrices: (G + G^T) / 2, G standard Gaussian.

A pool of ``traffic["pool"]`` distinct (n, n) matrices, made on the device
from the seed in one call; the calls of the window cycle through it.  The
entries are exactly symmetric (a float sum commutes).
"""
from __future__ import annotations

import torch


def make(config: dict, traffic: dict, seed: int, device) -> dict:
    n, pool = traffic["n"], traffic["pool"]
    dtype = getattr(torch, config["dtype"])
    g = torch.Generator(device=device).manual_seed(seed)
    G = torch.randn((pool, n, n), generator=g, device=device, dtype=dtype)
    S = (G + G.mT) * 0.5
    del G
    return {"pool": list(S.unbind(0))}
