"""repro_torch.models — the decoder LM (port of ``repro.models``).

Ported: the config, the meta-first parameters, norms and rotary, chunked
flash attention with its recomputing backward, GQA attention with
sliding windows, the dense MLPs and the MoE feed-forward (``dense`` and
``dropping``), the Mamba2 (SSD) and RG-LRU mixers, the "attn", "mamba2"
and "rglru" blocks, the stacked-unit LM (``forward``, ``LM``; hybrid
pattern units, and precomputed frontend embeddings through
``frontend_proj``), and one-token decode against caches (``cache_meta``,
``cache_init``, ``decode_step``; ring buffers for windowed layers,
recurrent states for Mamba2 and RG-LRU layers), and model sharding:
``partition_specs`` (a ``PartitionSpec`` per leaf from the rule tables of
``repro_torch.parallel.sharding``), attention's ``heads`` / ``q_heads`` /
``cp`` modes, the MoE's ``ep`` / ``capacity`` / ``tp`` modes, the
vocab-parallel embedding and head, FSDP gathers per unit and sequence
parallelism, all through ``repro_torch.parallel.hints``; and ``remat``
``"none"``, ``"block"`` and ``"dots"``; tensor parallelism of the Mamba2
(whole heads a rank, the gated norm's sum of squares reduced) and RG-LRU
(its width, the block-diagonal gates' heads gathered where a cut splits
one) mixers; and sharded decode (attention on its heads, or on a slice of
the cache's window where KV heads stay whole; the mixers' states on the
model axis).
"""
from .config import ModelConfig
from .params import ParamMeta, PartitionSpec, abstract_params, init_params, partition_specs, param_count
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
    "PartitionSpec",
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
