"""Minimal optax-style optimizer interface (port of ``repro.optim.base``)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["Optimizer", "apply_updates", "global_norm", "clip_by_global_norm"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]            # params -> state
    update: Callable[..., tuple]          # (grads, state, params) -> (updates, state)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return tree_map(lambda x: x * scale, tree), g
