"""Full decoder LM: embedding -> stacked pattern units -> head (port of
``repro.models.lm`` for training and prefill).

Layers are grouped into the smallest repeating **pattern unit** (one layer
for homogeneous archs) and their parameters are **stacked** along a leading
(n_units, ...) dimension, as the JAX package stacks them for ``lax.scan``:
``wq`` of llama3.2-3b is one (28, 3072, 24, 128) tensor, not 28 tensors.
Shampoo's blocking depends on it (a stacked leaf takes its leading
dimension as the batch).  :func:`forward` loops over the leading dimension;
with ``cfg.remat == "block"`` each unit runs under
``torch.utils.checkpoint`` (its activations are recomputed in the
backward).  Remainder layers run one by one.

Parameters are nested dicts of tensors (``model_params``), as in the JAX
package; :class:`LM` holds the same tree as ``nn.Parameter``s.  One-token
decode against a cache is the serve path and is not ported yet.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.tree import tree_map

from .blocks import ZERO_AUX, block_forward, block_meta
from .config import ModelConfig
from .layers import apply_norm, embed_lookup, embed_meta, rmsnorm_meta, unembed
from .params import ParamMeta, init_params

__all__ = ["pattern_unit", "model_meta", "model_params", "forward", "LM"]


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
        from repro_torch.backend import probe

        generator = torch.Generator(device=probe.resolve_device(device)).manual_seed(0)
    return init_params(model_meta(cfg, model_axis), generator, device)


def _embed_input(params, cfg: ModelConfig, tokens, embeds) -> torch.Tensor:
    dt = cfg.activation_dtype
    if embeds is not None:
        return embeds.to(dt) @ params["frontend_proj"].to(dt)
    return embed_lookup(params["embed"], tokens, dt)


def _unit_forward(cfg: ModelConfig, pat, unit_params, x):
    aux = dict(ZERO_AUX)
    for i, kind in enumerate(pat):
        x, a = block_forward(unit_params[f"L{i}_{kind}"], cfg, kind, x)
        aux = {k: aux[k] + a[k] for k in aux}
    return x, aux


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: Optional[torch.Tensor] = None,
    embeds: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence forward.  Returns (logits fp32, aux losses); with
    ``return_hidden`` the final-norm hidden states instead of logits
    (training streams the vocabulary in chunked cross-entropy)."""
    if cfg.remat not in ("none", "block", "full"):
        raise NotImplementedError(f"remat={cfg.remat!r}: the port checkpoints whole blocks only")
    pat, n_units, rem = pattern_unit(cfg)
    x = _embed_input(params, cfg, tokens, embeds)
    unit_fn = functools.partial(_unit_forward, cfg, pat)
    aux = {k: torch.zeros((), dtype=torch.float32, device=x.device) for k in ZERO_AUX}
    for u in range(n_units):
        unit_params = tree_map(lambda t: t[u], params["units"])
        if cfg.remat == "block":
            x, a = checkpoint(unit_fn, unit_params, x, use_reentrant=False)
        else:
            x, a = unit_fn(unit_params, x)
        aux = {k: aux[k] + a[k] for k in aux}
    for i, kind in enumerate(rem):
        x, a = block_forward(params["rem"][f"R{i}_{kind}"], cfg, kind, x)
        aux = {k: aux[k] + a[k] for k in aux}

    x = apply_norm(params["final_norm"], x, cfg.norm)
    if return_hidden:
        return x, aux
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return unembed(x, table, cfg.logit_softcap), aux


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
    ``lm(tokens)`` = :func:`forward` on them.  ``lm.params()`` gives the
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
