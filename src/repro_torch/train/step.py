"""Train / serve step builders (port of ``repro.train.step``).

``make_train_step`` returns a function

    (params, opt_state, batch, step) -> (params, opt_state, metrics)

on nested dicts of tensors: the loss is the shifted cross entropy (plus the
MoE aux terms, zero for dense blocks), with optional gradient microbatching
(sequential accumulation) and error-feedback int8 compression.  Gradients
come from ``torch.autograd.grad`` on detached copies of the parameters, so
the step is a pure function like its JAX counterpart and returns new
parameter tensors.

``make_prefill`` / ``make_serve_step`` build the inference entry points:
a full-sequence forward returning the next token, and one-token decode
against a cache (updated in place, as the JAX serve step donates it).
Both run under ``torch.inference_mode()`` on the device they are built
for.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.backend import probe
from repro_torch.models import ModelConfig, decode_step, forward
from repro_torch.optim import Optimizer, apply_updates, global_norm
from repro_torch.tree import flatten_with_paths, tree_map

__all__ = [
    "cross_entropy",
    "chunked_cross_entropy",
    "make_loss_fn",
    "make_train_step",
    "make_prefill",
    "make_serve_step",
]

MOE_LB_COEF = 0.01
MOE_Z_COEF = 1e-3
NEG = -1e30


def _ce_chunk(m, l, lab, W_c, h, labels, base: int, V: int, softcap):
    """One vocab chunk of the running logsumexp and of the label's logit."""
    CH = W_c.shape[0]
    lg = h.to(torch.float32) @ W_c.to(h.dtype).to(torch.float32).mT
    if softcap is not None:
        lg = softcap * torch.tanh(lg / softcap)
    col = base + torch.arange(CH, device=h.device)
    lg = torch.where((col < V)[None, None, :], lg, NEG)
    m_new = torch.maximum(m, lg.amax(-1))
    l = l * torch.exp(m - m_new) + torch.exp(lg - m_new[..., None]).sum(-1)
    idx = torch.clamp(labels.long() - base, 0, CH - 1)
    ll = torch.gather(lg, -1, idx[..., None])[..., 0]
    in_ch = (labels >= base) & (labels < base + CH)
    return m_new, l, torch.where(in_ch, ll, lab)


def chunked_cross_entropy(
    h: torch.Tensor,
    table: torch.Tensor,
    labels: torch.Tensor,
    softcap=None,
    n_chunks: int = 8,
) -> torch.Tensor:
    """Mean next-token CE without materializing (B, S, V) logits.

    Streams the unembedding over ``n_chunks`` vocab chunks with a running
    logsumexp, in float32; each chunk runs under ``torch.utils.checkpoint``
    (the backward recomputes its logits).  h: (B, S, D); table: (V, D).  The
    last position of each row has weight 0 (its label wraps).
    """
    B, S, D = h.shape
    V = table.shape[0]
    CH = -(-V // n_chunks)
    table_p = torch.nn.functional.pad(table, (0, 0, 0, CH * n_chunks - V))
    m = torch.full((B, S), NEG, dtype=torch.float32, device=h.device)
    l = torch.zeros((B, S), dtype=torch.float32, device=h.device)
    lab = torch.zeros((B, S), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        W_c = table_p[c * CH : (c + 1) * CH]
        m, l, lab = checkpoint(_ce_chunk, m, l, lab, W_c, h, labels, c * CH, V, softcap,
                               use_reentrant=False)
    nll = (m + torch.log(torch.clamp(l, min=1e-30))) - lab
    weights = torch.ones_like(nll)
    weights[:, -1] = 0.0
    return torch.sum(nll * weights) / torch.clamp(torch.sum(weights), min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE.  logits (B, S, V) fp32, labels (B, S) int.

    The final position of each row is down-weighted to zero (its label wraps).
    """
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    weights = torch.ones_like(ll)
    weights[:, -1] = 0.0
    return -torch.sum(ll * weights) / torch.clamp(torch.sum(weights), min=1.0)


def make_loss_fn(cfg: ModelConfig) -> Callable:
    def loss_fn(params, batch):
        kwargs = {}
        if cfg.frontend and "embeds" in batch:
            kwargs["embeds"] = batch["embeds"]
        else:
            kwargs["tokens"] = batch["tokens"]
        h, aux = forward(params, cfg, return_hidden=True, **kwargs)
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        ce = chunked_cross_entropy(
            h, table, batch["labels"], softcap=cfg.logit_softcap,
            n_chunks=max(min(8, cfg.vocab // 8192), 1),
        )
        loss = ce + MOE_LB_COEF * aux["moe_lb"] + MOE_Z_COEF * aux["moe_z"]
        metrics = {"loss": loss, "ce": ce, **aux}
        return loss, metrics

    return loss_fn


def value_and_grad(loss_fn: Callable, params, *args):
    """``((loss, metrics), grads)`` of ``loss_fn(params, *args)``, the
    gradients a tree like ``params`` (zeros where a leaf is unused)."""
    _, xs, rebuild = flatten_with_paths(params)
    xs = [x.detach().requires_grad_(True) for x in xs]
    with torch.enable_grad():
        loss, metrics = loss_fn(rebuild(xs), *args)
        gs = torch.autograd.grad(loss, xs, allow_unused=True)
    gs = [torch.zeros_like(x) if g is None else g for x, g in zip(xs, gs)]
    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), rebuild(gs)


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    *,
    microbatches: int = 1,
    compression=None,  # (init, apply) from ef_compress_transform
) -> Callable:
    loss_fn = make_loss_fn(cfg)

    def train_step(params, opt_state, batch, step):
        if microbatches <= 1:
            (loss, metrics), grads = value_and_grad(loss_fn, params, batch)
        else:
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            lsum = None
            for i in range(microbatches):
                mb_batch = {k: v[i * (v.shape[0] // microbatches) : (i + 1) * (v.shape[0] // microbatches)]
                            for k, v in batch.items()}
                (l, metrics), g = value_and_grad(loss_fn, params, mb_batch)
                gsum = tree_map(lambda a, b: a + b.to(torch.float32), gsum, g)
                lsum = l if lsum is None else lsum + l
            grads = tree_map(lambda g: g / microbatches, gsum)
            metrics["loss"] = lsum / microbatches

        ef_state = None
        if compression is not None:
            opt_state, ef_state = opt_state
            grads, ef_state = compression[1](grads, ef_state)

        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        metrics["grad_norm"] = global_norm(updates)
        if compression is not None:
            opt_state = (opt_state, ef_state)
        return params, opt_state, metrics

    return train_step


def make_prefill(cfg: ModelConfig, *, device: Optional[Union[str, torch.device]] = None) -> Callable:
    """Full-sequence inference forward — the prefill shape.  The returned
    ``prefill(params, batch)`` gives the next token (int32, (B,)) after
    each row of ``batch["tokens"]`` (or ``batch["embeds"]``), moved to
    ``device`` (default ``"cuda"``, which raises without a card: pass
    ``device="cpu"``)."""
    dev = probe.resolve_device(device)

    @torch.inference_mode()
    def prefill(params, batch):
        if cfg.frontend and "embeds" in batch:
            kwargs = {"embeds": batch["embeds"].to(dev)}
        else:
            kwargs = {"tokens": batch["tokens"].to(dev)}
        logits, _ = forward(params, cfg, **kwargs)
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)

    return prefill


def make_serve_step(cfg: ModelConfig, *, device: Optional[Union[str, torch.device]] = None) -> Callable:
    """One-token decode against a cache — the decode shapes.  The returned
    ``serve_step(params, cache, tokens)`` takes tokens (B, 1), moved to
    ``device`` (default ``"cuda"``, which raises without a card: pass
    ``device="cpu"``), and gives (the greedy next token, int32 (B,), the
    cache updated in place)."""
    dev = probe.resolve_device(device)

    @torch.inference_mode()
    def serve_step(params, cache, tokens):
        logits, cache = decode_step(params, cfg, cache, tokens=tokens.to(dev))
        return torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32), cache

    return serve_step
