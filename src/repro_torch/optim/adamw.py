"""AdamW with linear-warmup cosine decay — the baseline optimizer (port of
``repro.optim.adamw``)."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.tree import leaves, tree_map

from .base import Optimizer, clip_by_global_norm

__all__ = ["adamw", "AdamWState", "warmup_cosine", "constant_schedule"]


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-d, on the parameters' device
    mu: object
    nu: object


def warmup_cosine(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * warm * cos

    return schedule


def constant_schedule(lr):
    """``lr`` itself when it is a schedule, else a constant float32 one."""
    if callable(lr):
        return lr
    return lambda step: torch.full((), lr, dtype=torch.float32, device=torch.as_tensor(step).device)


def step_zero(params) -> torch.Tensor:
    """The optimizer's step counter, 0, on the parameters' device."""
    first = leaves(params)
    device = first[0].device if first else "cpu"
    return torch.zeros((), dtype=torch.int32, device=device)


def adamw(
    lr=3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    grad_clip: Optional[float] = 1.0,
) -> Optimizer:
    schedule = constant_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(step=step_zero(params), mu=tree_map(zeros, params), nu=tree_map(zeros, params))

    def update(grads, state, params):
        grads = tree_map(lambda g: g.to(torch.float32), grads)
        if grad_clip is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        step = state.step + 1
        lr_t = schedule(step)
        c1 = 1 - b1 ** step.to(torch.float32)
        c2 = 1 - b2 ** step.to(torch.float32)

        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)

        def upd(m, v, p):
            mhat = m / c1
            vhat = v / c2
            u = -lr_t * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.to(torch.float32))
            return u.to(p.dtype)

        updates = tree_map(upd, mu, nu, params)
        return updates, AdamWState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)
