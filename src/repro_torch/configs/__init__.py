"""repro_torch.configs — architecture configs (port of ``repro.configs``).

``get_config(arch_id)`` returns the full-scale ModelConfig and
``get_smoke_config`` the reduced CPU variant.  Ids use underscores, dashes
or the published spelling interchangeably.  Of the JAX package's ten
archs, llama3.2-3b (dense) is ported; the others need blocks the port does
not have yet and raise, naming ROADMAP Queue 1 item 13.
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
PORTED = ("llama32_3b",)

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
            f"arch {arch!r} is not ported yet: ROADMAP Queue 1 item 13 (the other model "
            f"families); ported: {list(PORTED)}"
        )
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke()
