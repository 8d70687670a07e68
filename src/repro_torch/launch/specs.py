"""Inputs of every (architecture x shape) dry-run cell (port of
``repro.launch.specs``).

Shapes (assigned, LM family):
    train_4k     seq 4096    global_batch 256   -> train_step
    prefill_32k  seq 32768   global_batch 32    -> prefill
    decode_32k   seq 32768   global_batch 128   -> serve_step (1 new token)
    long_500k    seq 524288  global_batch 1     -> serve_step (1 new token)

``long_500k`` runs only for the sub-quadratic-serving archs (SSM / hybrid /
SWA); pure full-attention archs skip it.  Where the JAX package gives
``jax.ShapeDtypeStruct`` s, the port gives tensors on torch's ``meta``
device in the same trees, shapes and dtypes.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs import canonical, get_config
from repro_torch.models import ModelConfig, abstract_params, cache_meta, model_meta

__all__ = ["SHAPES", "LONG_CONTEXT_ARCHS", "cell_applicable", "input_specs", "batch_specs", "all_cells"]

SHAPES: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# Sub-quadratic serving state: SSM state / RG-LRU + local window / SWA ring.
LONG_CONTEXT_ARCHS = {"mamba2_370m", "recurrentgemma_2b", "mixtral_8x7b"}


def cell_applicable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return canonical(arch) in LONG_CONTEXT_ARCHS
    return True


def all_cells():
    from repro_torch.configs import ARCHS

    for arch in ARCHS:
        for shape in SHAPES:
            yield arch, shape, cell_applicable(arch, shape)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, seq: int, batch: int, *, train: bool) -> dict:
    specs = {}
    if cfg.frontend:
        specs["embeds"] = _meta((batch, seq, cfg.frontend_dim), torch.bfloat16)
    else:
        specs["tokens"] = _meta((batch, seq), torch.int32)
    if train:
        specs["labels"] = _meta((batch, seq), torch.int32)
        if cfg.frontend:
            specs["tokens"] = _meta((batch, seq), torch.int32)
    return specs


def input_specs(
    arch: str,
    shape: str,
    *,
    optimizer=None,
    model_axis: int = 16,
    cfg: Optional[ModelConfig] = None,
) -> dict:
    """Meta-device inputs for the step function of this cell.

    train  -> {params, opt_state, batch, step}
    prefill-> {params, batch}
    decode -> {params, cache, tokens}
    """
    cfg = cfg or get_config(arch)
    info = SHAPES[shape]
    params = abstract_params(model_meta(cfg, model_axis))
    if info["kind"] == "train":
        out = {
            "params": params,
            "batch": batch_specs(cfg, info["seq"], info["batch"], train=True),
            "step": _meta((), torch.int32),
        }
        if optimizer is not None:
            from repro_torch.train.step import init_opt_state

            out["opt_state"] = init_opt_state(optimizer, params)
        return out
    if info["kind"] == "prefill":
        return {
            "params": params,
            "batch": batch_specs(cfg, info["seq"], info["batch"], train=False),
        }
    return {
        "params": params,
        "cache": cache_meta(cfg, info["batch"], info["seq"]),
        "tokens": _meta((info["batch"], 1), torch.int32),
    }
