"""Shared layer primitives: norms, rotary embeddings, token embedding
(port of ``repro.models.layers``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .params import ParamMeta

__all__ = [
    "rmsnorm_meta",
    "apply_norm",
    "rotary_cos_sin",
    "apply_rotary",
    "embed_meta",
    "embed_lookup",
    "unembed",
]


def rmsnorm_meta(dim: int, kind: str, dtype) -> dict:
    meta = {"scale": ParamMeta((dim,), dtype, ("embed",), init="ones")}
    if kind == "layernorm":
        meta["bias"] = ParamMeta((dim,), dtype, ("embed",), init="zeros")
    return meta


def apply_norm(params: dict, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last dim, in float32 inside."""
    xf = x.to(torch.float32)
    if kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].to(torch.float32) + params["bias"].to(torch.float32)
    else:  # rmsnorm
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps)
        y = y * params["scale"].to(torch.float32)
    return y.to(x.dtype)


def rotary_cos_sin(
    positions: torch.Tensor, head_dim: int, theta: float, dtype=torch.float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given (B?, S) integer positions; shape (..., S, hd/2)."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (..., S, hd/2) broadcast over heads.
    The half-split convention: the first and second halves of hd rotate
    as pairs."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def embed_meta(vocab: int, dim: int, dtype) -> ParamMeta:
    return ParamMeta((vocab, dim), dtype, ("vocab", "embed"), init="embed", scale=1.0)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # F.embedding's backward on CUDA sums repeated tokens in a fixed order.
    return F.embedding(tokens.long(), table).to(dtype)


def unembed(x: torch.Tensor, table: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    """Logits = x @ table^T, in float32."""
    logits = x.to(torch.float32) @ table.to(torch.float32).mT
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
