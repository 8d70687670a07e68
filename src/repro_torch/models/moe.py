"""Mixture-of-Experts FFN: top-k routing with two interchangeable backends
(port of ``repro.models.moe``).

* ``dense``    — every expert runs on every token, outputs combined with
  the (zero-filled) top-k softmax weights.  FLOP-wasteful (factor E/k);
  the correctness oracle and the small-scale smoke path.
* ``dropping`` — GShard/Switch capacity-based dispatch: per batch row the
  (S*k) routing choices are stably sorted by expert, the first C choices
  of each expert are gathered into an expert-major (B, E, C, D) buffer,
  run through the expert FFNs, and added back to their tokens; choices
  past an expert's capacity C are dropped.

Under a sharding resolver (``repro_torch.parallel.hints``) the router runs
whole on every model rank (its weights gathered where ``ep`` splits them)
and each rank computes one slice of the expert work, by the mode the
policy's rules give (``resolve_moe_mode``):

* ``ep``       — experts split on ``model``: each rank runs its experts;
* ``capacity`` — expert weights replicated, capacity slots split on
  ``model`` (the ``dense`` backend, which has no slots, splits the expert
  FFN dim of the replicated weights instead, as GSPMD does);
* ``tp``       — each expert's FFN dim (``expert_mlp``) split on ``model``.

The combined output is a partial sum reduced over ``model``.  The
load-balancing and z losses take their batch means over the whole batch
(summed over the data axes), so they equal the one-process values.

Router logits are float32 products of the activations and the router
weights (the JAX package asks for ``preferred_element_type=float32``; a
bf16 ``torch.einsum`` would round them to bf16), and ties in the top-k
go to the lower expert index, as ``jax.lax.top_k`` breaks them.  Aux
losses: the Switch load-balancing loss and the router z-loss, returned to
the caller for accumulation.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel import comm, hints

from .config import ModelConfig
from .params import ParamMeta

__all__ = ["moe_meta", "moe_forward", "padded_experts"]


def padded_experts(cfg: ModelConfig, model_axis: int = 16) -> int:
    """Expert count (no padding: when E doesn't divide the model axis the
    sharding policy splits each expert's FFN dim instead)."""
    return cfg.n_experts


def moe_meta(cfg: ModelConfig, pdtype, model_axis: int = 16) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    E = padded_experts(cfg, model_axis)
    return {
        "router": ParamMeta((d, E), pdtype, ("embed", "experts"), scale=0.1),
        "w_gate": ParamMeta((E, d, f), pdtype, ("experts", "embed", "expert_mlp"), fan_in_axis=1),
        "w_up": ParamMeta((E, d, f), pdtype, ("experts", "embed", "expert_mlp"), fan_in_axis=1),
        "w_down": ParamMeta((E, f, d), pdtype, ("experts", "expert_mlp", "embed"), fan_in_axis=1),
    }


def _act(cfg: ModelConfig, g: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation.
    return F.silu(g) if cfg.mlp_act == "swiglu" else F.gelu(g, approximate="tanh")


def _router(p, cfg: ModelConfig, x: torch.Tensor):
    """Top-k gating.  Returns (weights (B,S,k) fp32, idx (B,S,k), aux losses)."""
    E_pad = p["router"].shape[1]
    E = cfg.n_experts
    logits = x.to(torch.float32) @ p["router"].to(x.dtype).to(torch.float32)
    # Padding experts never win: mask their logits.
    if E_pad > E:
        logits = torch.where(torch.arange(E_pad, device=x.device) >= E, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[..., : cfg.top_k], idx[..., : cfg.top_k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)

    # Load-balance loss (Switch): E * sum_e f_e * p_e over real experts,
    # with the means over the whole batch.
    me = _batch_mean(probs.mean(dim=(0, 1)))
    ce = _batch_mean(F.one_hot(idx[..., 0], E_pad).to(torch.float32).mean(dim=(0, 1)))
    lb_loss = E * torch.sum(me * ce)
    z_loss = _batch_mean(torch.mean(torch.square(torch.logsumexp(logits, dim=-1))))
    return weights, idx, {"moe_lb": lb_loss, "moe_z": z_loss}


def _batch_mean(m: torch.Tensor) -> torch.Tensor:
    """The mean of per-rank batch means over the data axes (equal local
    batches); the identity without a resolver."""
    res = hints.active_resolver()
    axes = res.batch_axes() if res is not None else ()
    if not axes:
        return m
    return comm.all_reduce(m, res.mesh, axes) / res.size(axes)


def _work(cfg: ModelConfig, res) -> Tuple[Optional[str], Optional[str]]:
    """(mode, the logical name of the axes that split the expert work)."""
    if res is None:
        return None, None
    if res.axes("act_experts"):
        return "ep", "act_experts"
    if cfg.moe_impl == "dense":  # no slots: the expert FFN dim (JAX's hint there is act_mlp)
        if res.axes("act_mlp"):
            return ("tp" if res.axes("act_expert_mlp") else "capacity"), "act_mlp"
        return None, None
    if res.axes("act_capacity"):
        return "capacity", "act_capacity"
    if res.axes("act_expert_mlp"):
        return "tp", "act_expert_mlp"
    return None, None


def _expert_ffn(p, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h: (..., E, C, D) expert-major tokens -> same shape.  (``einsum``
    batches over E; a broadcast ``matmul`` would copy the weights once per
    leading index.)"""
    dt = h.dtype
    g = torch.einsum("...ecd,edf->...ecf", h, p["w_gate"].to(dt))
    u = torch.einsum("...ecd,edf->...ecf", h, p["w_up"].to(dt))
    hidden = hints.shard_hint(_act(cfg, g) * u, ("act_batch", "act_experts", "act_capacity", "act_expert_mlp"))
    return torch.einsum("...ecf,efd->...ecd", hidden, p["w_down"].to(dt))


def _moe_dense(p, cfg: ModelConfig, x: torch.Tensor, weights, idx, experts=(0, None)):
    """Every expert on every token; combine with scattered top-k weights.
    ``experts``: the range of experts whose weights ``p`` holds."""
    dt = x.dtype
    g = torch.einsum("bsd,edf->bsef", x, p["w_gate"].to(dt))
    u = torch.einsum("bsd,edf->bsef", x, p["w_up"].to(dt))
    h = hints.shard_hint(_act(cfg, g) * u, ("act_batch", None, "act_experts", "act_mlp"))
    y_e = torch.einsum("bsef,efd->bsed", h, p["w_down"].to(dt))
    w_full = torch.sum(F.one_hot(idx, cfg.n_experts).to(torch.float32) * weights[..., None], dim=-2)
    return torch.einsum("bsed,bse->bsd", y_e, w_full[..., experts[0]:experts[1]].to(dt))


def _capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per expert and batch row: 1.25 S k / E rounded up to 16, at
    least 16 and at most S k rounded up to 16."""
    k = cfg.top_k
    C = int(cfg.capacity_factor * S * k / cfg.n_experts)
    return min(max(((C + 15) // 16) * 16, 16), ((S * k + 15) // 16) * 16)


def _moe_dropping(p, cfg: ModelConfig, x: torch.Tensor, weights, idx, experts=(0, None), slots=(0, None)):
    """Capacity-based dispatch by sort / gather / scatter-add, batched over
    the rows (memory O(B E C D), no (S, E, C) one-hot dispatch tensors).
    The routing covers every expert and slot; the FFNs run on the ranges
    ``experts`` and ``slots`` (this rank's share under ep / capacity)."""
    B, S, D = x.shape
    E_pad = cfg.n_experts
    k = cfg.top_k
    C = _capacity(cfg, S)
    dev = x.device

    flat_e = idx.reshape(B, S * k)  # expert id per routing choice
    flat_w = weights.reshape(B, S * k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices  # choice ids, expert-major
    hist = torch.zeros((B, E_pad), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))  # routing choices per expert
    offs = torch.cumsum(hist, dim=-1) - hist
    slot_ids = torch.arange(C, device=dev)
    valid = slot_ids < torch.clamp(hist, max=C)[..., None]  # (B, E, C)
    # A slot past its expert's choices reads some choice, with weight 0.
    slot_idx = torch.clamp(offs[..., None] + slot_ids, max=S * k - 1)
    choice = torch.gather(order, 1, slot_idx.reshape(B, E_pad * C)).reshape(B, E_pad, C)
    choice = choice[:, experts[0]:experts[1], slots[0]:slots[1]]
    valid = valid[:, experts[0]:experts[1], slots[0]:slots[1]]
    E_loc, C_loc = choice.shape[1:]
    token = choice // k
    w = torch.gather(flat_w, 1, choice.reshape(B, -1)).reshape(B, E_loc, C_loc) * valid

    rows = torch.arange(B, device=dev)[:, None]
    h = x[rows, token.reshape(B, -1)].reshape(B, E_loc, C_loc, D) * valid[..., None].to(x.dtype)
    h = hints.shard_hint(h, ("act_batch", "act_experts", "act_capacity", None))
    y = _expert_ffn(p, cfg, h) * w[..., None].to(x.dtype)
    y = hints.shard_hint(y, ("act_batch", "act_experts", "act_capacity", None))
    # Add back to token order (a token's choices across experts sum).
    out = torch.zeros((B * S, D), dtype=x.dtype, device=dev)
    out.index_add_(0, (token + rows[..., None] * S).reshape(-1), y.reshape(-1, D))
    return out.reshape(B, S, D)


RES = ("act_batch", "act_res_seq", None)
WHOLE = ("act_batch", None, None)


def moe_forward(p: dict, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) in the residual stream's layout -> (out (B, S, D),
    {"moe_lb", "moe_z"}).  Each rank holds its block of ``p``."""
    res = hints.active_resolver()
    mode, work = _work(cfg, res)
    x = hints.shard_hint(x, WHOLE, src=RES)  # the router sees every token
    router = p["router"]
    if router.shape[1] != cfg.n_experts:  # ep splits the router's experts too
        router = comm.all_gather(router, res.mesh, res.axes("act_experts"), 1, grad="slice")
    weights, idx, aux = _router({"router": router}, cfg, x)
    experts, slots = (0, None), (0, None)
    if mode is not None:
        x = hints.tp_input(x, WHOLE, work)
        weights = hints.shared_param(weights, work)
        i = res.index(work)
        if mode == "ep":
            E_loc = p["w_gate"].shape[0]
            experts = (i * E_loc, (i + 1) * E_loc)
        elif mode == "capacity":  # replicated weights: their gradients summed over the work's ranks
            p = hints.shared_param({k: p[k] for k in ("w_gate", "w_up", "w_down")}, work)
            if cfg.moe_impl == "dense":  # this rank's block of the FFN dim
                f0, f1 = comm.chunk_bounds(cfg.d_ff, res.size(work), i)
                p = {"w_gate": p["w_gate"][..., f0:f1], "w_up": p["w_up"][..., f0:f1],
                     "w_down": p["w_down"][:, f0:f1]}
            else:
                slots = comm.chunk_bounds(_capacity(cfg, x.shape[1]), res.size(work), i)
    if cfg.moe_impl == "dense":
        out = _moe_dense(p, cfg, x, weights, idx, experts)
    else:
        out = _moe_dropping(p, cfg, x, weights, idx, experts, slots)
    if mode is None:
        return hints.shard_hint(out, RES, src=WHOLE), aux
    return hints.shard_hint(out, RES, partial=work), aux
