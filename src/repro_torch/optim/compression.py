"""Gradient compression with error feedback (port of ``repro.optim.compression``).

* ``quantize_int8`` / ``dequantize_int8`` — symmetric per-row int8 with a
  float32 scale per row.
* ``ef_compress_transform`` — error-feedback gradient transform for the
  trainer: g_q = Q(g + e); e' = (g + e) - g_q.
* ``compressed_psum`` — the int8 all-reduce across devices; not ported yet
  (it raises, naming ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import flatten_with_paths, leaves, tree_map

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum", "ef_compress_transform"]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization.  x: (..., n)."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError(
        "compressed_psum is an all-reduce across devices, which is not ported yet: "
        "ROADMAP Queue 1 item 12 (multi-device)"
    )


class EFState(NamedTuple):
    error: Any


def ef_compress_transform():
    """Error-feedback int8 compression as a gradient transform:
    ``(init, apply)`` with ``apply(grads, state) -> (grads_q, state)``."""

    def init(params):
        return EFState(error=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))

    def apply(grads, state: EFState):
        def one(g, e):
            x = g.to(torch.float32) + e
            flat = x.reshape(-1, x.shape[-1]) if x.ndim > 1 else x.reshape(1, -1)
            q, s = quantize_int8(flat)
            xq = dequantize_int8(q, s).reshape(x.shape)
            return xq, x - xq

        _, gleaves, rebuild = flatten_with_paths(grads)
        pairs = [one(g, e) for g, e in zip(gleaves, leaves(state.error))]
        return rebuild([p[0] for p in pairs]), EFState(error=rebuild([p[1] for p in pairs]))

    return init, apply
