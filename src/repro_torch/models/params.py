"""Meta-first parameter system (port of ``repro.models.params``).

Model definitions build a tree of :class:`ParamMeta` (shape, dtype, logical
axes, init law).  From it:

* ``abstract_params`` — the shapes, as tensors on torch's ``meta`` device
  (no allocation);
* ``init_params``     — materialized weights, from a ``torch.Generator``;
* ``param_count``.

The init laws and the fan-in rule are the JAX package's.  The stream is
torch's, not threefry: one generator drawn leaf after leaf in the tree's
order, so weights match the JAX package's in distribution only.
``partition_specs`` (sharding) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.backend import probe
from repro_torch.tree import flatten_with_paths, leaves, tree_map

__all__ = [
    "ParamMeta",
    "abstract_params",
    "init_params",
    "partition_specs",
    "param_count",
    "is_meta",
]


@dataclasses.dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    dtype: Any               # torch.dtype
    axes: Tuple[Optional[str], ...]
    init: str = "normal"     # normal | zeros | ones | embed | lru_a | ssm_alog | ssm_dtbias
    scale: float = 1.0       # stddev multiplier for "normal"
    fan_in_axis: Optional[int] = None  # axis index whose size sets 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.axes) == len(self.shape), (self.shape, self.axes)


def is_meta(x) -> bool:
    return isinstance(x, ParamMeta)


def abstract_params(meta_tree):
    """The tree's shapes and dtypes as ``meta``-device tensors."""
    return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype, device="meta"), meta_tree)


# Laws drawn from U[lo, hi] and mapped: the RG-LRU's Lambda, logit(u) so
# that a = sigmoid(Lambda) spreads in (0.9, 0.999); Mamba2's A_log, with
# A = -exp(A_log) in [-16, -1]; Mamba2's dt_bias, softplus^-1(u).
_UNIFORM_LAWS = {
    "lru_a": (0.9, 0.999, lambda u: torch.log(u / (1 - u))),
    "ssm_alog": (1.0, 16.0, torch.log),
    "ssm_dtbias": (1e-3, 1e-1, lambda u: u + torch.log(-torch.expm1(-u))),
}


def _draw(m: ParamMeta, gen: torch.Generator) -> torch.Tensor:
    if m.init == "zeros":
        return torch.zeros(m.shape, dtype=m.dtype, device=gen.device)
    if m.init == "ones":
        return torch.ones(m.shape, dtype=m.dtype, device=gen.device)
    if m.init in _UNIFORM_LAWS:
        lo, hi, law = _UNIFORM_LAWS[m.init]
        u = lo + (hi - lo) * torch.rand(m.shape, dtype=torch.float32, device=gen.device, generator=gen)
        return law(u).to(m.dtype)
    if m.init not in ("normal", "embed"):
        raise ValueError(f"unknown init law {m.init!r}")
    if m.fan_in_axis is not None:
        fan_in = m.shape[m.fan_in_axis]
    else:
        fan_in = m.shape[0] if len(m.shape) >= 2 else max(m.shape[-1], 1)
    std = m.scale / math.sqrt(fan_in)
    x = torch.randn(m.shape, dtype=torch.float32, device=gen.device, generator=gen)
    return (x * std).to(m.dtype)


def init_params(meta_tree, generator: torch.Generator,
                device: Optional[Union[str, torch.device]] = None):
    """Materialize weights, drawn on ``generator``'s device leaf by leaf in
    tree order, then placed on ``device`` (default ``"cuda"``, which raises
    without a card: pass ``device="cpu"``).  Deterministic given the
    generator's state."""
    dev = probe.resolve_device(device)
    _, metas, rebuild = flatten_with_paths(meta_tree)
    return rebuild([_draw(m, generator).to(dev) for m in metas])


def partition_specs(meta_tree, rules: Dict[Optional[str], Any]):
    raise NotImplementedError(
        "partition_specs maps logical axes to a device mesh, which is not ported yet: "
        "ROADMAP Queue 1 item 12(b) (model sharding)"
    )


def param_count(meta_tree) -> int:
    return sum(math.prod(m.shape) for m in leaves(meta_tree))
