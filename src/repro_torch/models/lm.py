"""Full decoder LM: embedding -> stacked pattern units -> head (port of
``repro.models.lm``).

Layers are grouped into the smallest repeating **pattern unit** (one layer
for homogeneous archs; (rglru, rglru, attn) for the hybrid
recurrentgemma, whose 26 layers are 8 units and a remainder of (rglru,
rglru)) and their parameters are **stacked** along a leading
(n_units, ...) dimension, as the JAX package stacks them for ``lax.scan``:
``wq`` of llama3.2-3b is one (28, 3072, 24, 128) tensor, not 28 tensors.
Shampoo's blocking depends on it (a stacked leaf takes its leading
dimension as the batch).  :func:`forward` loops over the leading dimension;
with ``cfg.remat == "block"`` each unit runs under
``torch.utils.checkpoint`` (its activations are recomputed in the
backward), and with ``"dots"`` under selective checkpointing that keeps
the outputs of matmuls without batch dims (``aten.mm`` / ``aten.addmm``)
and recomputes the rest, the counterpart of JAX's
``dots_with_no_batch_dims_saveable``.  Remainder layers run one by one.

Under a sharding resolver (``repro_torch.parallel.hints``, installed by the
sharded train step) the parameters are this rank's blocks: each unit
all-gathers its FSDP shards inside its checkpoint (so the backward's
recomputation gathers them again, and the gradients are reduce-scattered),
the embedding and the head are vocab-parallel (tokens outside the rank's
vocabulary rows masked, the partial sums reduced), and the residual stream
is split on the sequence between blocks under sequence parallelism.

Parameters are nested dicts of tensors (``model_params``), as in the JAX
package; :class:`LM` holds the same tree as ``nn.Parameter``s.

Entry points:
  * ``forward``     — full-sequence logits (train / prefill)
  * ``decode_step`` — one token against a cache, updated in place
  * ``model_meta`` / ``cache_meta`` — shapes (``ParamMeta`` / ``meta``
    tensors); ``model_params`` / ``cache_init`` materialize them

The cache is the JAX package's tree: ``units`` (each layer's K/V, or its
Mamba2 / RG-LRU state and conv window, stacked along n_units like the
parameters), ``rem`` and a 0-d int32 ``pos``, so a JAX-made cache carries
across with ``interop.model_params``.  Audio and vision archs take
precomputed frame / patch embeddings (``embeds``) through
``frontend_proj`` in the forward; decode takes tokens or embeds.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch.backend import probe
from repro_torch.parallel import hints
from repro_torch.tree import tree_map

from .blocks import ZERO_AUX, block_cache_meta, block_decode, block_forward, block_meta
from .config import ModelConfig
from .layers import apply_norm, embed_lookup, embed_meta, rmsnorm_meta, unembed
from .params import ParamMeta, init_params

__all__ = [
    "pattern_unit",
    "model_meta",
    "model_params",
    "cache_meta",
    "cache_init",
    "forward",
    "decode_step",
    "gathered",
    "LM",
]


def pattern_unit(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, Tuple[str, ...]]:
    """(unit pattern, n_units, remainder kinds)."""
    kinds = cfg.layer_kinds
    if cfg.family == "hybrid":
        pat = cfg.griffin_pattern or ("rglru", "rglru", "attn")
    else:
        pat = (kinds[0],)
    n_units = len(kinds) // len(pat)
    rem = kinds[n_units * len(pat):]
    return tuple(pat), n_units, tuple(rem)


def _stack_meta(tree, n: int):
    def f(m: ParamMeta):
        return ParamMeta(
            (n,) + m.shape,
            m.dtype,
            ("layers",) + m.axes,
            init=m.init,
            scale=m.scale,
            fan_in_axis=None if m.fan_in_axis is None else m.fan_in_axis + 1,
        )

    return tree_map(f, tree)


def model_meta(cfg: ModelConfig, model_axis: int = 16) -> dict:
    pd = cfg.parameter_dtype
    pat, n_units, rem = pattern_unit(cfg)
    unit = {f"L{i}_{kind}": block_meta(cfg, kind, model_axis) for i, kind in enumerate(pat)}
    meta = {
        "embed": embed_meta(cfg.vocab, cfg.d_model, pd),
        "final_norm": rmsnorm_meta(cfg.d_model, cfg.norm, pd),
        "units": _stack_meta(unit, n_units),
        "rem": {f"R{i}_{kind}": block_meta(cfg, kind, model_axis) for i, kind in enumerate(rem)},
    }
    if not cfg.tie_embeddings:
        meta["unembed"] = ParamMeta((cfg.vocab, cfg.d_model), pd, ("vocab", "embed"), scale=1.0)
    if cfg.frontend:
        meta["frontend_proj"] = ParamMeta((cfg.frontend_dim, cfg.d_model), pd, ("frontend", "embed"))
    return meta


def model_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                 model_axis: int = 16, *, device: Optional[Union[str, torch.device]] = None):
    """Random weights for ``cfg``, drawn from ``generator`` (default: a
    generator on ``device`` seeded with 0) and placed on ``device`` (default
    ``"cuda"``, which raises without a card: pass ``device="cpu"``)."""
    if generator is None:
        generator = torch.Generator(device=probe.resolve_device(device)).manual_seed(0)
    return init_params(model_meta(cfg, model_axis), generator, device)


RES = ("act_batch", "act_res_seq", None)  # the residual stream's layout
WHOLE = ("act_batch", None, None)


def _embed_input(params, cfg: ModelConfig, tokens, embeds) -> torch.Tensor:
    dt = cfg.activation_dtype
    res = hints.active_resolver()
    if embeds is not None:
        x = embeds.to(dt) @ params["frontend_proj"].to(dt)
        return hints.shard_hint(x, RES, src=WHOLE)
    if res is not None and res.axes("act_vocab"):
        # Vocab-parallel: this rank's rows of the table, other tokens masked;
        # the partial sums (one rank holds each token) reduced in float32.
        table = params["embed"]
        rows = table.shape[0]
        t = tokens.long() - res.index("act_vocab") * rows
        mine = (t >= 0) & (t < rows)
        x = F.embedding(t.clamp(0, rows - 1), table) * mine[..., None].to(table.dtype)
        return hints.shard_hint(x, RES, partial="act_vocab").to(dt)
    return hints.shard_hint(embed_lookup(params["embed"], tokens, dt), RES, src=WHOLE)


def _unit_forward(cfg: ModelConfig, pat, unit_params, x, specs=None):
    res = hints.active_resolver()
    if res is not None:
        unit_params = res.gather_params(unit_params, specs)
    aux = dict(ZERO_AUX)
    for i, kind in enumerate(pat):
        x, a = block_forward(unit_params[f"L{i}_{kind}"], cfg, kind, x)
        aux = {k: aux[k] + a[k] for k in aux}
    return x, aux


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Keep the outputs of matmuls without batch dims; recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def gathered(params: dict, key: str, specs=None):
    """``params[key]`` with its FSDP shards gathered under a resolver that
    knows the parameter specs (``specs``: the tree's, default the
    resolver's)."""
    res = hints.active_resolver()
    if res is None:
        return params[key]
    specs = res.param_specs if specs is None else specs
    return res.gather_params(params[key], None if specs is None else specs[key])


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward.  Returns (logits fp32, aux losses); with
    ``return_hidden`` the final-norm hidden states instead of logits
    (training streams the vocabulary in chunked cross-entropy).  Under a
    sharding resolver the hidden states are in the residual stream's layout
    and the logits are this rank's vocabulary columns."""
    if cfg.remat not in ("none", "block", "full", "dots"):
        raise ValueError(f"remat={cfg.remat!r}: one of none, block, full, dots")
    res = hints.active_resolver()
    specs = res.param_specs if res is not None else None
    pat, n_units, rem = pattern_unit(cfg)
    used = ["final_norm", "frontend_proj" if embeds is not None else "embed"]
    if cfg.tie_embeddings and not return_hidden:
        used.append("embed")
    top = {k: gathered(params, k, specs) for k in dict.fromkeys(used)}  # one order on every rank
    x = _embed_input(top, cfg, tokens, embeds)
    unit_specs = None
    if specs is not None:
        from repro_torch.models.params import PartitionSpec

        unit_specs = tree_map(lambda sp: PartitionSpec(*tuple(sp)[1:]), specs["units"])
    # Bound to the resolver: a checkpoint recomputes on the backward's thread.
    unit_fn = hints.bind(functools.partial(_unit_forward, cfg, pat, specs=unit_specs))
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device) for k in ZERO_AUX}
    for u in range(n_units):
        unit_params = tree_map(lambda t: t[u], params["units"])
        if cfg.remat == "block":
            x, a = checkpoint(unit_fn, unit_params, x, use_reentrant=False)
        elif cfg.remat == "dots":
            x, a = checkpoint(unit_fn, unit_params, x, use_reentrant=False, context_fn=_dots_context)
        else:
            x, a = unit_fn(unit_params, x)
        aux = {k: aux[k] + a[k] for k in aux}
    for i, kind in enumerate(rem):
        key = f"R{i}_{kind}"
        x, a = block_forward(gathered(params["rem"], key, None if specs is None else specs["rem"]), cfg, kind, x)
        aux = {k: aux[k] + a[k] for k in aux}

    x = apply_norm(hints.shared_param(top["final_norm"], "act_res_seq"), x, cfg.norm)
    if return_hidden:
        return x, aux
    table = top["embed"] if cfg.tie_embeddings else gathered(params, "unembed", specs)
    x = hints.tp_input(x, RES, "act_vocab")
    logits = unembed(x, table, cfg.logit_softcap)
    return hints.shard_hint(logits, ("act_batch", None, "act_vocab")), aux


# ----------------------------------------------------------------------
# Decode
# ----------------------------------------------------------------------

def cache_meta(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The decode cache's shapes and dtypes as ``meta``-device tensors."""
    pat, n_units, rem = pattern_unit(cfg)

    def stack(tree):
        return tree_map(lambda t: torch.empty((n_units, *t.shape), dtype=t.dtype, device="meta"), tree)

    unit = {f"L{i}_{kind}": block_cache_meta(cfg, kind, batch, max_len) for i, kind in enumerate(pat)}
    return {
        "units": stack(unit),
        "rem": {f"R{i}_{kind}": block_cache_meta(cfg, kind, batch, max_len) for i, kind in enumerate(rem)},
        "pos": torch.empty((), dtype=torch.int32, device="meta"),
    }


def cache_init(cfg: ModelConfig, batch: int, max_len: int, *,
               device: Optional[Union[str, torch.device]] = None) -> dict:
    """A zero cache (``pos`` 0) on ``device`` (default ``"cuda"``, which
    raises without a card: pass ``device="cpu"``)."""
    dev = probe.resolve_device(device)
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev),
                    cache_meta(cfg, batch, max_len))


def decode_step(
    params: dict,
    cfg: ModelConfig,
    cache: dict,
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, dict]:
    """One decode step.  tokens: (B, 1) int (or embeds (B, 1, F)), on the
    cache's device.

    Returns (logits (B, 1, V) fp32, cache): the same cache dict, its K/V
    written in place (the JAX serve step donates it) and ``pos`` + 1.

    Under a sharding resolver the parameters and the cache are this rank's
    blocks (``launch.cache_specs``) and the tokens its rows of the batch:
    the step runs under the resolver's decode rules
    (``MeshResolver.for_decode``), gathers each unit's FSDP shards, and
    returns the rank's vocabulary columns of the logits."""
    res = hints.active_resolver()
    if res is not None:
        res = res.for_decode()
    with hints.hint_resolver(res):
        return _decode(params, cfg, cache, tokens, embeds, res)


def _decode(params, cfg: ModelConfig, cache, tokens, embeds, res):
    pat, n_units, rem = pattern_unit(cfg)
    specs = res.param_specs if res is not None else None
    unit_specs = None
    if specs is not None:
        from repro_torch.models.params import PartitionSpec

        unit_specs = tree_map(lambda sp: PartitionSpec(*tuple(sp)[1:]), specs["units"])
    used = ["final_norm", "frontend_proj" if embeds is not None else "embed"]
    used.append("embed" if cfg.tie_embeddings else "unembed")
    top = {k: gathered(params, k, specs) for k in dict.fromkeys(used)}  # one order on every rank
    pos = cache["pos"]
    x = _embed_input(top, cfg, tokens, embeds)
    for u in range(n_units):
        unit = tree_map(lambda t: t[u], params["units"])
        if res is not None:
            unit = res.gather_params(unit, unit_specs)
        for i, kind in enumerate(pat):
            key = f"L{i}_{kind}"
            x, _ = block_decode(unit[key], cfg, kind, x, tree_map(lambda t: t[u], cache["units"][key]), pos)
    for i, kind in enumerate(rem):
        key = f"R{i}_{kind}"
        x, _ = block_decode(gathered(params["rem"], key, None if specs is None else specs["rem"]), cfg, kind, x,
                            cache["rem"][key], pos)

    x = apply_norm(top["final_norm"], x, cfg.norm)
    table = top["embed"] if cfg.tie_embeddings else top["unembed"]
    cache["pos"] = pos + 1
    logits = unembed(x, table, cfg.logit_softcap)
    return hints.shard_hint(logits, ("act_batch", None, "act_vocab")), cache


class _ParamTree(nn.Module):
    """A nested dict of tensors held as submodules and ``nn.Parameter``s."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, _ParamTree(value))
            else:
                self.register_parameter(key, nn.Parameter(value))

    def tree(self) -> dict:
        out = {name: p for name, p in self._parameters.items()}
        out.update({name: m.tree() for name, m in self._modules.items()})
        return out


class LM(nn.Module):
    """The decoder LM as an ``nn.Module``: ``params`` (a tree from
    :func:`model_params`) held as stacked ``nn.Parameter``s, and
    ``lm(tokens)`` = :func:`forward` and ``lm.decode_step(cache, tokens)``
    = :func:`decode_step` on them.  ``lm.params()`` gives the
    tree back (the Parameters themselves) for the functional train step and
    optimizers."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.weights = _ParamTree(params)

    def params(self) -> dict:
        return self.weights.tree()

    def forward(self, tokens=None, embeds=None, return_hidden: bool = False):
        return forward(self.params(), self.cfg, tokens, embeds, return_hidden)

    def decode_step(self, cache: dict, tokens=None, embeds=None):
        """:func:`decode_step` on the module's weights."""
        return decode_step(self.params(), self.cfg, cache, tokens, embeds)
