"""Shampoo with EVD-powered preconditioners — the solver's consumer.

Port of ``repro.optim.shampoo``.  Shampoo (Gupta et al.) preconditions each
2-D parameter block G with L^{-1/4} G R^{-1/4}, where L = EMA[G G^T] and
R = EMA[G^T G].  The inverse fourth roots are symmetric EVD problems,
computed by ONE call per side to
``repro_torch.solver.solve_many(stats, evd, op="inverse_pth_root")``: on the
card that is kernels A, B and C once per block.  ``ShampooOptions.evd`` (a
:class:`repro_torch.solver.EvdConfig`) carries all solver tuning, and
``ShampooOptions.precond_mesh`` (a mesh or a ``(mesh, axes)`` pair) is that
call's ``devices=``: each rank refreshes its slice of the blocks and every
rank gets them all, so ranks with equal parameters and gradients end each
step with bitwise-equal preconditioners and parameters.

Layout: every eligible parameter is cut into (block, block) tiles; all tiles
across the whole model are stacked into ONE (NB, bs, bs) batch, in the
order ``repro_torch.tree`` walks the parameters (sorted dict keys, as
``jax.tree_util`` does), so each leaf's ``offset`` into the stack matches
the JAX package's.  A 3-D or 4-D leaf takes its leading (stacked-layer)
dimension as the batch and splits the rest into its most square (m, n).
1-D leaves and embeddings fall back to Adam.

Under a sharded train step Shampoo sees whole leaves
(``Optimizer.whole_leaves``): the step gathers each leaf's gradient, runs
this update on the whole tree (its refresh split across ranks by
``precond_mesh``) and keeps its own block of the update, so the state is
the one-process state, replicated on every rank.

Grafting: AdaGrad-norm grafting (the update rescaled to the diagonal-Adam
update's norm per parameter).  The refresh runs at step 1 and at every
multiple of ``update_interval``: a Python branch on the step, where the JAX
package has ``lax.cond``.  On fake tensors (the dry-run) the step has no
value and refreshes: the JAX walk counts both branches of its ``cond``, an
upper bound, and the other branch is free.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.backend.trace import is_fake
from repro_torch.solver import EvdConfig, solve_many
from repro_torch.tree import flatten_with_paths, leaves, tree_map

from .adamw import constant_schedule, step_zero
from .base import Optimizer, clip_by_global_norm

__all__ = ["shampoo", "ShampooState", "ShampooOptions", "leaf_plans"]


@dataclasses.dataclass(frozen=True)
class ShampooOptions:
    block_size: int = 128
    update_interval: int = 10       # preconditioner refresh period
    beta2: float = 0.99             # stats EMA
    beta1: float = 0.9              # momentum
    eps: float = 1e-6               # root ridge
    graft_eps: float = 1e-8
    max_dim_for_shampoo: int = 65536
    vocab_threshold: int = 16384    # leaves with a dim this big use Adam
    evd: EvdConfig = EvdConfig(b=8, nb=64)  # the solver plan config
    precond_mesh: Any = None        # optional (mesh, axes) to shard the EVD batch


class ShampooState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    mu: Any             # momentum tree
    nu: Any             # diagonal second moment (grafting + fallback)
    stats_l: torch.Tensor  # (NB, bs, bs)
    stats_r: torch.Tensor
    pre_l: torch.Tensor
    pre_r: torch.Tensor


def _leaf_plan(path: str, shape, opts: ShampooOptions):
    """Decide how a leaf is preconditioned.  Returns dict or None (diag)."""
    if len(shape) < 2:
        return None
    if max(shape) > opts.max_dim_for_shampoo:
        return None
    # Embedding-like leaves: any dim above the vocab threshold -> Adam.
    if max(shape) >= opts.vocab_threshold and ("embed" in path or "unembed" in path):
        return None
    if len(shape) == 2:
        batch, m, n = 1, shape[0], shape[1]
    else:
        # Leading dim = stacked layers (batch); split the rest into the most
        # square (m, n) factorization.
        batch = shape[0]
        rest = list(shape[1:])
        best, best_ratio = 1, float("inf")
        prod_all = 1
        for d in rest:
            prod_all *= d
        acc = 1
        for j in range(1, len(rest)):
            acc *= rest[j - 1]
            ratio = max(acc, prod_all // acc) / max(min(acc, prod_all // acc), 1)
            if ratio < best_ratio:
                best_ratio, best = ratio, j
        m = 1
        for d in rest[:best]:
            m *= d
        n = prod_all // m
    bs = opts.block_size
    nbm = -(-m // bs)
    nbn = -(-n // bs)
    return dict(batch=batch, m=m, n=n, nbm=nbm, nbn=nbn, count=batch * nbm * nbn)


def leaf_plans(params, opts: ShampooOptions):
    """``(plans, NB)``: each leaf's plan (None: Adam) with its ``offset``
    into the (NB, bs, bs) stack, in leaf order.  Only shapes are read, so
    ``params`` may hold meta tensors."""
    paths, leaf_list, _ = flatten_with_paths(params)
    plans, offset = [], 0
    for path, leaf in zip(paths, leaf_list):
        plan = _leaf_plan(path, tuple(leaf.shape), opts)
        if plan is not None:
            plan["offset"] = offset
            offset += plan["count"]
        plans.append(plan)
    return plans, max(offset, 1)


def _to_blocks(g: torch.Tensor, plan, bs: int) -> torch.Tensor:
    b, m, n = plan["batch"], plan["m"], plan["n"]
    nbm, nbn = plan["nbm"], plan["nbn"]
    g = g.reshape(b, m, n).to(torch.float32)
    g = F.pad(g, (0, nbn * bs - n, 0, nbm * bs - m))
    g = g.reshape(b, nbm, bs, nbn, bs).permute(0, 1, 3, 2, 4)
    return g.reshape(b * nbm * nbn, bs, bs)


def _from_blocks(blocks: torch.Tensor, plan, bs: int, shape) -> torch.Tensor:
    b, m, n = plan["batch"], plan["m"], plan["n"]
    nbm, nbn = plan["nbm"], plan["nbn"]
    g = blocks.reshape(b, nbm, nbn, bs, bs).permute(0, 1, 3, 2, 4)
    g = g.reshape(b, nbm * bs, nbn * bs)[:, :m, :n]
    return g.reshape(shape)


def shampoo(
    lr=1e-3,
    opts: ShampooOptions = ShampooOptions(),
    weight_decay: float = 0.0,
    grad_clip: Optional[float] = 1.0,
) -> Optimizer:
    schedule = constant_schedule(lr)
    bs = opts.block_size

    def init(params):
        _, nb = leaf_plans(params, opts)
        device = leaves(params)[0].device
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        stats = lambda: torch.zeros((nb, bs, bs), dtype=torch.float32, device=device)
        eye = lambda: torch.eye(bs, dtype=torch.float32, device=device).repeat(nb, 1, 1)
        return ShampooState(
            step=step_zero(params),
            mu=tree_map(zeros, params),
            nu=tree_map(zeros, params),
            stats_l=stats(),
            stats_r=stats(),
            pre_l=eye(),
            pre_r=eye(),
        )

    def _roots(stats):
        return solve_many(stats, opts.evd, op="inverse_pth_root", p=4, eps=opts.eps,
                          devices=opts.precond_mesh)

    def update(grads, state, params):
        _, gleaves, rebuild = flatten_with_paths(grads)
        pleaves = leaves(params)
        plans, _ = leaf_plans(params, opts)
        grads_f: List[torch.Tensor] = [g.to(torch.float32) for g in gleaves]
        if grad_clip is not None:
            grads_f, _ = clip_by_global_norm(grads_f, grad_clip)

        step = state.step + 1
        lr_t = schedule(step)

        # ---- diagonal stats (grafting + fallback) -------------------------
        nu_new = [0.99 * v + 0.01 * g * g for v, g in zip(leaves(state.nu), grads_f)]

        # ---- gather blocks, update Kronecker stats ------------------------
        blocks = [_to_blocks(g, plan, bs) for g, plan in zip(grads_f, plans) if plan is not None]
        if blocks:
            G = torch.cat(blocks)
            L = opts.beta2 * state.stats_l + (1 - opts.beta2) * (G @ G.mT)
            R = opts.beta2 * state.stats_r + (1 - opts.beta2) * (G.mT @ G)
        else:
            G = torch.zeros((1, bs, bs), dtype=torch.float32, device=state.stats_l.device)
            L, R = state.stats_l, state.stats_r

        # ---- refresh preconditioners every update_interval ----------------
        # A fake step has no value: it refreshes (the branch that costs).
        refresh = is_fake(step)
        if not refresh:
            s = int(step)
            refresh = s == 1 or s % opts.update_interval == 0
        if refresh:
            pre_l, pre_r = _roots(L), _roots(R)
        else:
            pre_l, pre_r = state.pre_l, state.pre_r

        # ---- precondition + graft -----------------------------------------
        P = pre_l @ G @ pre_r if blocks else G

        updates = []
        c2 = 1.0 - 0.99 ** step.to(torch.float32)  # bias correction
        for g, p, v, plan in zip(grads_f, pleaves, nu_new, plans):
            adam_dir = g / (torch.sqrt(v / c2) + opts.graft_eps)
            if plan is None:
                u = adam_dir
            else:
                blk = P[plan["offset"] : plan["offset"] + plan["count"]]
                pg = _from_blocks(blk, plan, bs, g.shape)
                graft = torch.linalg.norm(adam_dir.reshape(-1)) / torch.clamp(
                    torch.linalg.norm(pg.reshape(-1)), min=1e-16
                )
                u = pg * graft
            updates.append(u + weight_decay * p.to(torch.float32))

        # ---- momentum ------------------------------------------------------
        mu_new = [opts.beta1 * m + u for m, u in zip(leaves(state.mu), updates)]
        out = [(-lr_t * m).to(p.dtype) for m, p in zip(mu_new, pleaves)]
        return rebuild(out), ShampooState(
            step=step,
            mu=rebuild(mu_new),
            nu=rebuild(nu_new),
            stats_l=L,
            stats_r=R,
            pre_l=pre_l,
            pre_r=pre_r,
        )

    return Optimizer(init=init, update=update, whole_leaves=True)
