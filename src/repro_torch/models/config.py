"""Model configuration (port of ``repro.models.config``).

The JAX package's one dataclass with the same fields and defaults, so a
config converts field by field; the dtype properties give ``torch.dtype``.
Family-specific fields are unused by other families (the port runs the
dense ``attn`` blocks).  Configs are constructed by
``repro_torch.configs.<arch>`` modules; reduced smoke variants by
``.scaled()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


def _dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm

    # trunk
    n_layers: int = 2
    d_model: int = 128
    vocab: int = 256

    # attention
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 32
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None  # SWA (mixtral); None = full attention
    attn_logit_softcap: Optional[float] = None

    # mlp
    d_ff: int = 256
    mlp_act: str = "swiglu"  # swiglu | geglu | gelu (non-gated)
    norm: str = "rmsnorm"  # rmsnorm | layernorm

    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "dropping"  # dropping (GShard) | dense (masked oracle)

    # ssm (mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # griffin / RG-LRU (recurrentgemma)
    griffin_pattern: Tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "attn")
    local_window: int = 2048  # local attention window for hybrid blocks
    lru_width: Optional[int] = None

    # frontends (audio / vlm backbones take precomputed embeddings)
    frontend: Optional[str] = None  # None | "audio" | "vision"
    frontend_dim: int = 0

    # embeddings / head
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None

    # numerics
    dtype: str = "bfloat16"       # activation dtype
    param_dtype: str = "float32"  # parameter dtype

    # training-time behaviour
    remat: str = "block"  # none | block | full
    attn_chunk: int = 1024     # flash-attention query-chunk length
    attn_kv_chunk: int = 1024  # flash-attention key/value-chunk length
    # attention TP mode, set by the launcher from the mesh:
    #   heads | q_heads | cp (context parallel over query chunks) | none
    attn_shard_mode: str = "none"
    # MoE sharding mode, set by the launcher from the mesh:
    #   ep (experts on model) | tp (expert FFN dim on model) |
    #   capacity (weights replicated, capacity slots on model)
    moe_shard_mode: str = "tp"

    # ------------------------------------------------------------------
    @property
    def activation_dtype(self) -> torch.dtype:
        return _dtype(self.dtype)

    @property
    def parameter_dtype(self) -> torch.dtype:
        return _dtype(self.param_dtype)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind, length n_layers."""
        if self.family == "ssm":
            return ("mamba2",) * self.n_layers
        if self.family == "hybrid":
            pattern = self.griffin_pattern or ("rglru", "rglru", "attn")
            kinds = []
            while len(kinds) < self.n_layers:
                kinds.extend(pattern)
            return tuple(kinds[: self.n_layers])
        return ("attn",) * self.n_layers

    def scaled(self, **overrides) -> "ModelConfig":
        """A reduced config of the same family (for CPU smoke tests)."""
        base = dict(
            n_layers=min(self.n_layers, 2 if self.family != "hybrid" else 3),
            d_model=64,
            vocab=min(self.vocab, 512),
            n_heads=2,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=96 if self.n_experts == 0 else 32,
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else self.ssm_headdim,
            ssm_chunk=16,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            local_window=32,
            sliding_window=32 if self.sliding_window else None,
            lru_width=None,
            frontend_dim=32 if self.frontend else 0,
            attn_chunk=32,
            attn_kv_chunk=32,
            dtype="float32",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)

    # param-count estimate (for roofline MODEL_FLOPS)
    def param_counts(self) -> dict:
        d, f, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        kinds = self.layer_kinds
        qdim = self.n_heads * self.head_dim
        kvdim = self.n_kv_heads * self.head_dim
        attn = d * qdim + 2 * d * kvdim + qdim * d
        if self.mlp_act in ("swiglu", "geglu"):
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        total = 0
        active = 0
        for kind in kinds:
            if kind == "attn":
                blk = attn + (
                    mlp
                    if self.n_experts == 0
                    else self.n_experts * 3 * d * f + d * self.n_experts
                )
                blk_active = attn + (
                    mlp if self.n_experts == 0 else self.top_k * 3 * d * f + d * self.n_experts
                )
            elif kind == "mamba2":
                di, ns, hd = self.d_inner, self.ssm_state, self.ssm_headdim
                g = self.ssm_ngroups
                in_proj = d * (2 * di + 2 * g * ns + di // hd)
                blk = in_proj + di * d + self.ssm_conv * (di + 2 * g * ns) + di
                blk_active = blk
            elif kind == "rglru":
                w = self.lru_width or d
                bw = w // max(self.n_heads, 1)
                gates = 2 * self.n_heads * bw * bw  # block-diagonal a/x gates
                blk = 2 * d * w + w * d + self.ssm_conv * w + gates + 3 * w + mlp
                blk_active = blk
            else:
                raise ValueError(kind)
            total += blk
            active += blk_active
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.frontend:
            emb += self.frontend_dim * d
        return {
            "total": total + emb,
            "active": active + emb,
            "body_total": total,
            "body_active": active,
        }
