"""repro_torch.configs — architecture configs (port of ``repro.configs``).

``get_config(arch_id)`` returns the full-scale ModelConfig and
``get_smoke_config`` the reduced CPU variant.  Ids use underscores, dashes
or the published spelling interchangeably.  All ten of the JAX package's
archs are ported (``PORTED == ARCHS``): the dense llama3.2-3b,
codeqwen1.5-7b, stablelm-3b and qwen3-14b, the MoE granite-moe-3b-a800m
and mixtral-8x7b, the SSM mamba2-370m, the hybrid recurrentgemma-2b, and
the audio and vision backbones musicgen-large and llava-next-mistral-7b
(their frontends are stubs: the model takes precomputed embeddings).
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
PORTED = tuple(ARCHS)

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
    return importlib.import_module(f"repro_torch.configs.{canonical(arch)}")


def get_config(arch: str):
    return _module(arch).config()


def get_smoke_config(arch: str):
    return _module(arch).smoke()
