"""repro_torch.models — the dense decoder LM (port of ``repro.models``).

Ported: the config, the meta-first parameters, norms and rotary, chunked
flash attention with its recomputing backward, GQA attention, the dense
MLPs, the "attn" block and the stacked-unit LM (``forward``, ``LM``).  Not
yet: MoE, Mamba2 and RG-LRU blocks (ROADMAP Queue 1 item 13), one-token
decode and caches (the serve path), ``partition_specs`` (item 12).
"""
from .config import ModelConfig
from .params import ParamMeta, abstract_params, init_params, partition_specs, param_count
from .lm import LM, forward, model_meta, model_params, pattern_unit

__all__ = [
    "ModelConfig",
    "ParamMeta",
    "abstract_params",
    "init_params",
    "partition_specs",
    "param_count",
    "model_meta",
    "model_params",
    "forward",
    "pattern_unit",
    "LM",
]
