"""Gradient compression with error feedback (port of ``repro.optim.compression``).

* ``quantize_int8`` / ``dequantize_int8`` — symmetric per-row int8 with a
  float32 scale per row.
* ``ef_compress_transform`` — error-feedback gradient transform for the
  trainer: g_q = Q(g + e); e' = (g + e) - g_q.
* ``compressed_psum`` — the int8 all-reduce-mean over a mesh axis: 1 byte
  an element on the wire (summed as int32) plus a float32 scale a row.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.comm import all_reduce_sum, axes_group
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
    """All-reduce-mean of ``x`` over the ranks of ``mesh``'s ``axis`` with an
    int8 payload; ``x`` is >= 1-D, its rows the leading dimensions.

    Each rank quantizes its ``x`` (per-row int8), the payloads are summed as
    int32 and the scales as float32, and the mean is rebuilt with the mean
    scale: ``total * (s_tot / n) / n``.  The JAX package takes one
    replicated ``x`` (``P()``); here each rank may pass its own, and every
    rank gets the same result.
    """
    group, _ = axes_group(mesh, axis)
    q, s = quantize_int8(x)
    total = all_reduce_sum(q.to(torch.int32), group)
    s_tot = all_reduce_sum(s, group)  # scales are close; use the mean scale
    n = float(dist.get_world_size(group))
    return (total.to(torch.float32) * (s_tot / n)) / n


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
