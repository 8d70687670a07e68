"""Minimal optax-style optimizer interface (port of ``repro.optim.base``).

Under a sharded train step an optimizer sees this rank's blocks of the
parameters and gradients.  ``Optimizer.whole_leaves`` says whether it
needs whole leaves instead (Shampoo's blocks are blocks of the whole leaf:
the step gathers them and keeps this rank's block of the update).  An
element-wise optimizer (AdamW) runs on the blocks; only its global norm
needs the other ranks, and :func:`sharded_norm` tells :func:`global_norm`
which mesh axes split each leaf, so that the squares are summed over them
and a replicated leaf is counted once.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["Optimizer", "apply_updates", "global_norm", "clip_by_global_norm", "sharded_norm"]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]            # params -> state
    update: Callable[..., tuple]          # (grads, state, params) -> (updates, state)
    whole_leaves: bool = False            # needs whole leaves under sharding (Shampoo)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


_state = threading.local()


@contextlib.contextmanager
def sharded_norm(mesh, leaf_axes: Sequence[Tuple[str, ...]]):
    """Within this context, :func:`global_norm` of a tree with
    ``len(leaf_axes)`` leaves sums each leaf's squares over the mesh axes
    ``leaf_axes[i]`` that split it (``()``: replicated, counted once)."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, [tuple(a) for a in leaf_axes])
    try:
        yield
    finally:
        _state.ctx = prev


def global_norm(tree) -> torch.Tensor:
    xs = leaves(tree)
    ctx = getattr(_state, "ctx", None)
    if ctx is None or len(ctx[1]) != len(xs):
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in xs))
    from repro_torch.parallel import comm

    mesh, leaf_axes = ctx
    groups = {}
    for x, axes in zip(xs, leaf_axes):
        groups.setdefault(axes, []).append(torch.sum(torch.square(x.float())))
    total = None
    for axes in sorted(groups):  # one all-reduce per set of axes, in a fixed order
        part = torch.stack(groups[axes]).sum()
        if axes:
            part = comm.all_reduce(part, mesh, axes, tag="grad")
        total = part if total is None else total + part
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    g = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(g, min=1e-12), max=1.0)
    return tree_map(lambda x: x * scale, tree), g
