"""repro_torch.configs — architecture configs (port of ``repro.configs``).

``get_config(arch_id)`` returns the full-scale ModelConfig and
``get_smoke_config`` the reduced CPU variant.  Ids use underscores, dashes
or the published spelling interchangeably.  Of the JAX package's ten
archs, the six whose layers are all attention are ported: the dense
llama3.2-3b, codeqwen1.5-7b, stablelm-3b and qwen3-14b, and the MoE
granite-moe-3b-a800m and mixtral-8x7b.  The other four need the Mamba2 or
RG-LRU block or a frontend, and raise, naming ROADMAP Queue 1 item 13(b).
"""
from __future__ import annotations

import importlib

__all__ = ["ARCHS", "canonical", "get_config", "get_smoke_config"]

ARCHS = [
    "mamba2_370m",
    "recurrentgemma_2b",
    "codeqwen15_7b",
    "llama32_3b",
    "stablelm_3b",
    "qwen3_14b",
    "granite_moe_3b_a800m",
    "mixtral_8x7b",
    "musicgen_large",
    "llava_next_mistral_7b",
]
PORTED = (
    "codeqwen15_7b",
    "llama32_3b",
    "stablelm_3b",
    "qwen3_14b",
    "granite_moe_3b_a800m",
    "mixtral_8x7b",
)
# What each unported arch still needs.
_MISSING = {
    "mamba2_370m": "the Mamba2 block",
    "recurrentgemma_2b": "the RG-LRU block",
    "musicgen_large": "the audio frontend",
    "llava_next_mistral_7b": "the vision frontend",
}

_ALIASES = {
    "mamba2-370m": "mamba2_370m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "codeqwen15-7b": "codeqwen15_7b",
    "llama3.2-3b": "llama32_3b",
    "llama32-3b": "llama32_3b",
    "stablelm-3b": "stablelm_3b",
    "qwen3-14b": "qwen3_14b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "mixtral-8x7b": "mixtral_8x7b",
    "musicgen-large": "musicgen_large",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}


def canonical(arch: str) -> str:
    a = arch.replace("-", "_").replace(".", "")
    a = _ALIASES.get(arch, _ALIASES.get(a, a))
    if a not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    return a


def _module(arch: str):
    name = canonical(arch)
    if name not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: it needs {_MISSING[name]}, ROADMAP Queue 1 "
            f"item 13(b); ported: {list(PORTED)}"
        )
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke()
