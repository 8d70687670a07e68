"""Meta-first parameter system (port of ``repro.models.params``).

Model definitions build a tree of :class:`ParamMeta` (shape, dtype, logical
axes, init law).  From it:

* ``abstract_params`` — the shapes, as tensors on torch's ``meta`` device
  (no allocation);
* ``init_params``     — materialized weights, from a ``torch.Generator``;
* ``partition_specs`` — a ``PartitionSpec`` per leaf from logical -> mesh
  axis rules (``repro_torch.parallel.sharding``);
* ``param_count``.

The init laws and the fan-in rule are the JAX package's.  The stream is
torch's, not threefry: one generator drawn leaf after leaf in the tree's
order, so weights match the JAX package's in distribution only.
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
    "PartitionSpec",
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


class PartitionSpec:
    """Mesh axes per dim: ``None``, a mesh-axis name, or a tuple of names
    (``jax.sharding.PartitionSpec``'s entries).  Iterates and compares like
    the tuple of its entries; not a tuple itself, so a tree of specs keeps
    each spec as one leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return tuple(self) == tuple(other) if isinstance(other, (PartitionSpec, tuple)) else NotImplemented

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"PartitionSpec{self.entries!r}"


def partition_specs(meta_tree, rules: Dict[Optional[str], Any]):
    """Map logical axes -> mesh axes.  ``rules`` values are mesh axis names
    (str), tuples of names, or None (replicated).  A mesh axis may split
    one dim of a leaf: a later dim that repeats it loses it."""

    def spec(m: ParamMeta):
        seen = set()
        clean = []
        for ax in m.axes:
            r = rules.get(ax, None)
            names = r if isinstance(r, tuple) else ((r,) if r else ())
            keep = tuple(x for x in names if x not in seen)
            seen.update(keep)
            if len(keep) == 0:
                clean.append(None)
            elif len(keep) == 1:
                clean.append(keep[0])
            else:
                clean.append(keep)
        return PartitionSpec(*clean)

    return tree_map(spec, meta_tree)


def param_count(meta_tree) -> int:
    return sum(math.prod(m.shape) for m in leaves(meta_tree))
