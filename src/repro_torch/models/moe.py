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

Router logits are float32 products of the activations and the router
weights (the JAX package asks for ``preferred_element_type=float32``; a
bf16 ``torch.einsum`` would round them to bf16), and ties in the top-k
go to the lower expert index, as ``jax.lax.top_k`` breaks them.  Aux
losses: the Switch load-balancing loss and the router z-loss, returned to
the caller for accumulation.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

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

    # Load-balance loss (Switch): E * sum_e f_e * p_e over real experts.
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx[..., 0], E_pad).to(torch.float32).mean(dim=(0, 1))
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return weights, idx, {"moe_lb": lb_loss, "moe_z": z_loss}


def _expert_ffn(p, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """h: (..., E, C, D) expert-major tokens -> same shape.  (``einsum``
    batches over E; a broadcast ``matmul`` would copy the weights once per
    leading index.)"""
    dt = h.dtype
    g = torch.einsum("...ecd,edf->...ecf", h, p["w_gate"].to(dt))
    u = torch.einsum("...ecd,edf->...ecf", h, p["w_up"].to(dt))
    return torch.einsum("...ecf,efd->...ecd", _act(cfg, g) * u, p["w_down"].to(dt))


def _moe_dense(p, cfg: ModelConfig, x: torch.Tensor, weights, idx):
    """Every expert on every token; combine with scattered top-k weights."""
    E_pad = p["router"].shape[1]
    dt = x.dtype
    g = torch.einsum("bsd,edf->bsef", x, p["w_gate"].to(dt))
    u = torch.einsum("bsd,edf->bsef", x, p["w_up"].to(dt))
    y_e = torch.einsum("bsef,efd->bsed", _act(cfg, g) * u, p["w_down"].to(dt))
    w_full = torch.sum(F.one_hot(idx, E_pad).to(torch.float32) * weights[..., None], dim=-2)
    return torch.einsum("bsed,bse->bsd", y_e, w_full.to(dt))


def _capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per expert and batch row: 1.25 S k / E rounded up to 16, at
    least 16 and at most S k rounded up to 16."""
    k = cfg.top_k
    C = int(cfg.capacity_factor * S * k / cfg.n_experts)
    return min(max(((C + 15) // 16) * 16, 16), ((S * k + 15) // 16) * 16)


def _moe_dropping(p, cfg: ModelConfig, x: torch.Tensor, weights, idx):
    """Capacity-based dispatch by sort / gather / scatter-add, batched over
    the rows (memory O(B E C D), no (S, E, C) one-hot dispatch tensors)."""
    B, S, D = x.shape
    E_pad = p["router"].shape[1]
    k = cfg.top_k
    C = _capacity(cfg, S)
    dev = x.device

    flat_e = idx.reshape(B, S * k)  # expert id per routing choice
    flat_w = weights.reshape(B, S * k)
    order = torch.sort(flat_e, dim=-1, stable=True).indices  # choice ids, expert-major
    hist = torch.zeros((B, E_pad), dtype=torch.int64, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))  # routing choices per expert
    offs = torch.cumsum(hist, dim=-1) - hist
    slots = torch.arange(C, device=dev)
    valid = slots < torch.clamp(hist, max=C)[..., None]  # (B, E, C)
    # A slot past its expert's choices reads some choice, with weight 0.
    slot_idx = torch.clamp(offs[..., None] + slots, max=S * k - 1)
    choice = torch.gather(order, 1, slot_idx.reshape(B, E_pad * C))  # (B, E*C)
    token = choice // k
    w = torch.gather(flat_w, 1, choice).reshape(B, E_pad, C) * valid

    rows = torch.arange(B, device=dev)[:, None]
    h = x[rows, token].reshape(B, E_pad, C, D) * valid[..., None].to(x.dtype)
    y = _expert_ffn(p, cfg, h) * w[..., None].to(x.dtype)
    # Add back to token order (a token's choices across experts sum).
    out = torch.zeros((B * S, D), dtype=x.dtype, device=dev)
    out.index_add_(0, (token + rows * S).reshape(-1), y.reshape(B * E_pad * C, D))
    return out.reshape(B, S, D)


def moe_forward(p: dict, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (out (B, S, D), {"moe_lb", "moe_z"})."""
    weights, idx, aux = _router(p, cfg, x)
    if cfg.moe_impl == "dense":
        out = _moe_dense(p, cfg, x, weights, idx)
    else:
        out = _moe_dropping(p, cfg, x, weights, idx)
    return out, aux
