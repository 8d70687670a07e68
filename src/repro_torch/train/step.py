"""Train / serve step builders (port of ``repro.train.step``).

``make_train_step`` returns a function

    (params, opt_state, batch, step) -> (params, opt_state, metrics)

on nested dicts of tensors: the loss is the shifted cross entropy (plus the
MoE aux terms, zero for dense blocks), with optional gradient microbatching
(sequential accumulation) and error-feedback int8 compression.  Gradients
come from ``torch.autograd.grad`` on detached copies of the parameters, so
the step is a pure function like its JAX counterpart and returns new
parameter tensors.

With ``policy=`` (a ``repro_torch.parallel.ShardingPolicy``) the step is
the sharded one: every rank calls it on its blocks of the parameters
(``shard_params``' DTensors, or the local tensors themselves) and its rows
of the batch, under the policy's hint resolver.  The loss is the mean over
the whole batch; gradients are summed over the data axes (FSDP leaves by
the reduce-scatter of their gathers, the rest by one all-reduce per set of
axes), and over ``model`` where the model code's region edges say so
(``repro_torch.parallel.hints``).  The cross entropy runs over the rank's
vocabulary columns and combines the per-row max, sum-exp and label logit
across the model axis in float32.  An element-wise optimizer updates the
blocks, with its global norm over the whole gradient; one that needs whole
leaves (``Optimizer.whole_leaves``: Shampoo) gets them gathered and hands
back the rank's block of its update.

``make_prefill`` / ``make_serve_step`` build the inference entry points:
a full-sequence forward returning the next token, and one-token decode
against a cache (updated in place, as the JAX serve step donates it).
Both run under ``torch.inference_mode()`` on the device they are built
for, and with ``policy=`` sharded as the train step is (each rank its
blocks of the parameters and of the cache, its rows of the batch).
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.backend import probe
from repro_torch.models import ModelConfig, decode_step, forward, model_meta
from repro_torch.models.lm import gathered
from repro_torch.optim import Optimizer, apply_updates, global_norm
from repro_torch.optim.base import sharded_norm
from repro_torch.parallel import comm, hints
from repro_torch.tree import flatten_with_paths, leaves, tree_map

__all__ = [
    "cross_entropy",
    "chunked_cross_entropy",
    "make_loss_fn",
    "make_train_step",
    "init_opt_state",
    "make_prefill",
    "make_serve_step",
    "greedy",
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

    Under a sharding resolver, ``h`` is in the residual stream's layout,
    ``table`` is this rank's block of vocabulary rows (``act_vocab``) and
    ``labels`` the rank's rows of the batch: the per-row max, sum-exp and
    label logit are combined over the vocabulary's ranks, and the mean is
    over the whole batch (the data axes' sums).
    """
    res = hints.active_resolver()
    vocab_axes = res.axes("act_vocab") if res is not None else ()
    h = hints.tp_input(h, ("act_batch", "act_res_seq", None), "act_vocab")
    B, S, D = h.shape
    V = table.shape[0]
    v0 = res.index("act_vocab") * V if vocab_axes else 0
    labels = labels.long() - v0
    CH = -(-V // n_chunks)
    table_p = torch.nn.functional.pad(table, (0, 0, 0, CH * n_chunks - V))
    m = torch.full((B, S), NEG, dtype=torch.float32, device=h.device)
    l = torch.zeros((B, S), dtype=torch.float32, device=h.device)
    lab = torch.zeros((B, S), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        W_c = table_p[c * CH : (c + 1) * CH]
        m, l, lab = checkpoint(_ce_chunk, m, l, lab, W_c, h, labels, c * CH, V, softcap,
                               use_reentrant=False)
    if vocab_axes:  # one rank holds each label; the max only shifts the sum
        M = comm.all_reduce_max(m, res.mesh, vocab_axes)
        l = comm.all_reduce(l * torch.exp(m - M), res.mesh, vocab_axes)
        lab = comm.all_reduce(lab, res.mesh, vocab_axes)
        m = M
    nll = (m + torch.log(torch.clamp(l, min=1e-30))) - lab
    weights = torch.ones_like(nll)
    weights[:, -1] = 0.0
    num, den = torch.sum(nll * weights), torch.sum(weights)
    batch_axes = res.batch_axes() if res is not None else ()
    if batch_axes:
        num = comm.all_reduce(num, res.mesh, batch_axes)
        den = comm.all_reduce(den, res.mesh, batch_axes)
    return num / torch.clamp(den, min=1.0)


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
        res = hints.active_resolver()
        table = gathered(params, "embed" if cfg.tie_embeddings else "unembed")
        if cfg.tie_embeddings and res is not None and res.param_specs is not None:
            # One FSDP gather of the tied table serves the lookup and the head.
            specs = dict(res.param_specs, embed=res.local_spec(res.param_specs["embed"]))
            with hints.hint_resolver(res.with_params(specs)):
                h, aux = forward(dict(params, embed=table), cfg, return_hidden=True, **kwargs)
        else:
            h, aux = forward(params, cfg, return_hidden=True, **kwargs)
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


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _like(new, old):
    """``new`` (a local tensor) held as ``old`` is: a DTensor with its
    placements when ``old`` is one."""
    from torch.distributed.tensor import DTensor

    if not isinstance(old, DTensor):
        return new
    return DTensor.from_local(new, old.device_mesh, old.placements, run_check=False,
                              shape=old.shape, stride=old.stride())


def _rewrap(new_tree, old_tree):
    return tree_map(_like, new_tree, old_tree)


def _sync_grads(grads, shardings, res):
    """Sum each leaf's gradient over the batch axes that do not split it
    (FSDP leaves were reduce-scattered by their gathers' backward): one
    float32 all-reduce per set of axes."""
    batch = res.batch_axes()
    _, gs, rebuild = flatten_with_paths(grads)
    shs = leaves(shardings)
    buckets = {}
    for i, (g, sh) in enumerate(zip(gs, shs)):
        axes = tuple(a for a in batch if a not in sh.axes())
        if axes:
            buckets.setdefault(axes, []).append(i)
    gs = list(gs)
    for axes, idx in sorted(buckets.items()):
        flat = comm.all_reduce(torch.cat([gs[i].reshape(-1).to(torch.float32) for i in idx]),
                               res.mesh, axes, tag="grad")
        off = 0
        for i in idx:
            n = gs[i].numel()
            gs[i] = flat[off:off + n].reshape(gs[i].shape).to(gs[i].dtype)
            off += n
    return rebuild(gs)


def init_opt_state(optimizer: Optimizer, params):
    """``optimizer.init`` for the params a (sharded) train step takes: on
    the rank's blocks, with every params-shaped tree of the state held as
    ``params`` is (DTensors for DTensor leaves); for an optimizer that needs
    whole leaves (Shampoo), on the gathered whole tree (its state then
    replicated on every rank)."""
    from repro_torch.parallel.sharding import gather_params

    if optimizer.whole_leaves:
        return optimizer.init(gather_params(params))
    state = optimizer.init(tree_map(_local, params))
    pp = flatten_with_paths(params)[0]

    def wrap(sub):
        return _rewrap(sub, params) if isinstance(sub, dict) and flatten_with_paths(sub)[0] == pp else sub

    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(wrap(v) for v in state))
    return wrap(state)


def make_train_step(
    cfg: ModelConfig,
    optimizer: Optimizer,
    *,
    microbatches: int = 1,
    compression=None,  # (init, apply) from ef_compress_transform
    policy=None,
) -> Callable:
    """The train step; with ``policy`` the sharded one (module docstring):
    ``params`` are this rank's blocks (DTensors or local tensors),
    ``opt_state`` comes from :func:`init_opt_state`, and ``batch`` holds the
    rank's rows of the global batch."""
    loss_fn = make_loss_fn(cfg)
    resolver = shardings = None
    if policy is not None:
        meta = model_meta(cfg)
        specs = policy.param_specs(meta)
        shardings = policy.param_shardings(meta)
        resolver = policy.resolver().with_params(specs)

    def grads_of(params, batch):
        if microbatches <= 1:
            return value_and_grad(loss_fn, params, batch)
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
        lsum = None
        for i in range(microbatches):
            mb_batch = {k: v[i * (v.shape[0] // microbatches) : (i + 1) * (v.shape[0] // microbatches)]
                        for k, v in batch.items()}
            (l, metrics), g = value_and_grad(loss_fn, params, mb_batch)
            gsum = tree_map(lambda a, b: a + b.to(torch.float32), gsum, g)
            lsum = l if lsum is None else lsum + l
        metrics["loss"] = lsum / microbatches
        return (metrics["loss"], metrics), tree_map(lambda g: g / microbatches, gsum)

    def train_step(params, opt_state, batch, step):
        with hints.hint_resolver(resolver):
            local = tree_map(_local, params)
            state = tree_map(_local, opt_state)
            (loss, metrics), grads = grads_of(local, batch)
            if resolver is not None:
                grads = _sync_grads(grads, shardings, resolver)

            ef_state = None
            if compression is not None:
                state, ef_state = state
                grads, ef_state = compression[1](grads, ef_state)

            if resolver is not None and optimizer.whole_leaves:
                whole = lambda t, sh, tag: sh.gather(t, tag=tag)
                g_all = tree_map(lambda g, sh: whole(g, sh, "grad"), grads, shardings)
                p_all = tree_map(lambda p, sh: whole(p, sh, "param"), local, shardings)
                upd_all, state = optimizer.update(g_all, state, p_all)
                metrics["grad_norm"] = global_norm(upd_all)
                updates = tree_map(lambda u, sh: sh.shard(u), upd_all, shardings)
            elif resolver is not None:
                with sharded_norm(resolver.mesh, [sh.axes() for sh in leaves(shardings)]):
                    updates, state = optimizer.update(grads, state, local)
                    metrics["grad_norm"] = global_norm(updates)
            else:
                updates, state = optimizer.update(grads, state, local)
                metrics["grad_norm"] = global_norm(updates)
            new = apply_updates(local, updates)
            if compression is not None:
                state = (state, ef_state)
        return _rewrap(new, params), _rewrap(state, opt_state), metrics

    return train_step


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The argmax over the last dim of ``logits`` (..., V), int32; ties go
    to the lowest index, as ``jnp.argmax`` breaks them.  Under a resolver
    that splits the vocabulary (``act_vocab``) ``logits`` are this rank's
    columns: each rank's max and its index are reduced over those axes."""
    idx = torch.argmax(logits, dim=-1)
    res = hints.active_resolver()
    axes = res.axes("act_vocab") if res is not None else ()
    if not axes:
        return idx.to(torch.int32)
    best = torch.gather(logits, -1, idx[..., None])[..., 0].to(torch.float32)
    top = comm.all_reduce_max(best, res.mesh, axes)
    first = (idx + res.index(axes) * logits.shape[-1]).to(torch.float32)  # exact below 2^24
    first = torch.where(best == top, first, float("inf"))
    return (-comm.all_reduce_max(-first, res.mesh, axes)).to(torch.int32)


def _inference_resolver(cfg: ModelConfig, policy):
    if policy is None:
        return None
    return policy.resolver().with_params(policy.param_specs(model_meta(cfg)))


def make_prefill(cfg: ModelConfig, *, policy=None, device: Optional[Union[str, torch.device]] = None) -> Callable:
    """Full-sequence inference forward — the prefill shape.  The returned
    ``prefill(params, batch)`` gives the next token (int32, (B,)) after
    each row of ``batch["tokens"]`` (or ``batch["embeds"]``), moved to
    ``device`` (default ``"cuda"``, which raises without a card: pass
    ``device="cpu"``).

    With ``policy`` every rank calls it on its blocks of the parameters
    (``shard_params``) and its rows of the batch, and gets its rows' tokens;
    the forward is the sharded train step's, and the greedy token is
    reduced over the vocabulary's ranks."""
    dev = probe.resolve_device(device)
    resolver = _inference_resolver(cfg, policy)

    @torch.inference_mode()
    def prefill(params, batch):
        if cfg.frontend and "embeds" in batch:
            kwargs = {"embeds": batch["embeds"].to(dev)}
        else:
            kwargs = {"tokens": batch["tokens"].to(dev)}
        with hints.hint_resolver(resolver):
            logits, _ = forward(tree_map(_local, params), cfg, **kwargs)
            return greedy(logits[:, -1, :])

    return prefill


def make_serve_step(cfg: ModelConfig, *, policy=None, device: Optional[Union[str, torch.device]] = None) -> Callable:
    """One-token decode against a cache — the decode shapes.  The returned
    ``serve_step(params, cache, tokens)`` takes tokens (B, 1), moved to
    ``device`` (default ``"cuda"``, which raises without a card: pass
    ``device="cpu"``), and gives (the greedy next token, int32 (B,), the
    cache updated in place).

    With ``policy`` every rank calls it on its blocks of the parameters,
    its blocks of the cache (``launch.cache_specs.cache_partition_specs``,
    cut by ``shard_cache``) and its rows of the tokens (all of them where
    the batch does not divide the data axes, as the cache's rows), and gets
    its rows' tokens (``lm.decode_step`` under a resolver)."""
    dev = probe.resolve_device(device)
    resolver = _inference_resolver(cfg, policy)

    @torch.inference_mode()
    def serve_step(params, cache, tokens):
        with hints.hint_resolver(resolver):
            logits, cache = decode_step(tree_map(_local, params), cfg, cache, tokens=tokens.to(dev))
            return greedy(logits[:, -1, :]), cache

    return serve_step
