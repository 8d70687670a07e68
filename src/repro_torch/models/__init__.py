"""repro_torch.models — the decoder LM (port of ``repro.models``).

Ported: the config, the meta-first parameters, norms and rotary, chunked
flash attention with its recomputing backward, GQA attention with
sliding windows, the dense MLPs and the MoE feed-forward (``dense`` and
``dropping``), the Mamba2 (SSD) and RG-LRU mixers, the "attn", "mamba2"
and "rglru" blocks, the stacked-unit LM (``forward``, ``LM``; hybrid
pattern units, and precomputed frontend embeddings through
``frontend_proj``), and one-token decode against caches (``cache_meta``,
``cache_init``, ``decode_step``; ring buffers for windowed layers,
recurrent states for Mamba2 and RG-LRU layers).  Not yet:
``partition_specs`` (ROADMAP Queue 1 item 12(b), model sharding).
"""
from .config import ModelConfig
from .params import ParamMeta, abstract_params, init_params, partition_specs, param_count
from .lm import (
    LM,
    cache_init,
    cache_meta,
    decode_step,
    forward,
    model_meta,
    model_params,
    pattern_unit,
)

__all__ = [
    "ModelConfig",
    "ParamMeta",
    "abstract_params",
    "init_params",
    "partition_specs",
    "param_count",
    "model_meta",
    "model_params",
    "cache_meta",
    "cache_init",
    "forward",
    "decode_step",
    "pattern_unit",
    "LM",
]
