"""Sharding rules: logical axis names -> mesh axes (port of
``repro.parallel.sharding``).

Two rule tables per mesh, key for key and value for value the JAX
package's:
  * ``param_rules``      — for ParamMeta logical axes (models/params.py)
  * ``activation_rules`` — for shard_hint logical names

Strategy (Megatron + optional FSDP/SP):
  - "model" axis: vocab, q/kv heads, mlp hidden, experts  (TP / EP)
  - "data"+"pod" axes: batch (DP); optionally the embed axis of big params
    (FSDP)
  - sequence parallelism: residual-stream seq dim on "model" between blocks

A parameter spec is a ``PartitionSpec`` of mesh-axis names per dim.  Where
the JAX package hands specs to ``jax.jit`` and ``device_put``, the port
cuts each rank's shard itself (:func:`shard_params`) and keeps it in a
``DTensor`` with its placements (:class:`NamedSharding`), as a container:
the step computes on ``to_local()`` and moves data only through
``repro_torch.parallel.comm``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.tree import flatten_with_paths, tree_map

from . import comm
from .hints import make_mesh_resolver

__all__ = [
    "ShardingPolicy", "NamedSharding", "make_policy", "named_sharding_tree",
    "resolve_attn_mode", "resolve_moe_mode", "shard_params", "gather_params",
]


def resolve_moe_mode(cfg, model_size: int) -> str:
    """ep | capacity | tp — which MoE parallelism fits this arch.

    capacity: replicate expert weights, shard the capacity dim on "model".
    Chosen when the whole expert stack is small enough to replicate
    (granite: 40 x 3 x 1536 x 512 x 4B = 0.5 GB).  Large-expert archs
    (mixtral) keep TP; true EP when E divides the axis.
    """
    e = getattr(cfg, "n_experts", 0) or 0
    if not e:
        return "tp"
    if e % model_size == 0:
        return "ep"
    per_layer_bytes = 3 * e * cfg.d_model * cfg.d_ff * 4
    if per_layer_bytes <= 2 * 2**30:
        return "capacity"
    return "tp"


def resolve_attn_mode(cfg, model_size: int) -> str:
    """heads | q_heads | cp — which attention TP strategy fits this arch."""
    nh = getattr(cfg, "n_heads", 0) or 0
    nkv = getattr(cfg, "n_kv_heads", 0) or 0
    if nh and nh % model_size == 0:
        return "heads" if (nkv and nkv % model_size == 0) else "q_heads"
    return "cp"


def _names(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else ((entry,) if entry else ())


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the port's counterpart of
    ``jax.sharding.NamedSharding``.  ``placements`` are DTensor's (one per
    mesh dim: ``Shard(d)`` or ``Replicate()``); :meth:`shard` cuts this
    rank's block of a whole tensor."""
    mesh: object
    spec: Tuple

    def _mesh_dims(self):
        """Per tensor dim, the mesh dims that split it, in spec order."""
        names = tuple(self.mesh.mesh_dim_names)
        out = []
        for entry in self.spec:
            dims = tuple(names.index(a) for a in _names(entry))
            if list(dims) != sorted(dims):
                raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
            out.append(dims)
        return out

    @property
    def placements(self):
        from torch.distributed.tensor import Replicate, Shard

        pl = [Replicate()] * self.mesh.ndim
        for d, dims in enumerate(self._mesh_dims()):
            for i in dims:
                pl[i] = Shard(d)
        return tuple(pl)

    def local_shape(self, shape, path: str = "") -> Tuple[int, ...]:
        """The block shape of a tensor of ``shape``; raises ``ValueError``
        (naming ``path`` and the axes) where a dim is not divisible."""
        if len(shape) != len(self.spec):
            raise ValueError(f"{path}: spec {tuple(self.spec)} for a tensor of shape {tuple(shape)}")
        out = []
        for n, entry, dims in zip(shape, self.spec, self._mesh_dims()):
            k = 1
            for i in dims:
                k *= self.mesh.size(i)
            if n % k:
                raise ValueError(f"{path}: dim of size {n} is not divisible by the mesh axes {_names(entry)} "
                                 f"({k} ranks)")
            out.append(n // k)
        return tuple(out)

    def shard(self, x: torch.Tensor, path: str = "") -> torch.Tensor:
        """This rank's block of the whole tensor ``x``."""
        local = self.local_shape(x.shape, path)
        for d, (entry, n) in enumerate(zip(self.spec, local)):
            axes = _names(entry)
            if axes and n != x.shape[d]:
                x = x.narrow(d, comm.axes_group(self.mesh, axes)[1] * n, n)
        return x.contiguous()

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis that splits some dim."""
        return tuple(a for entry in self.spec for a in _names(entry))

    def gather(self, local: torch.Tensor, *, tag: str = "param") -> torch.Tensor:
        """The whole tensor from every rank's block (the inverse of
        :meth:`shard`), by c10d ``all_gather``; no gradient."""
        with torch.no_grad():
            for d, (entry, dims) in enumerate(zip(self.spec, self._mesh_dims())):
                if math.prod(self.mesh.size(i) for i in dims) > 1:
                    local = comm.all_gather(local, self.mesh, _names(entry), d, tags=(tag, tag))
        return local


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: object
    param_rules: Dict[Optional[str], object]
    activation_rules: Dict[str, object]

    def resolver(self):
        return make_mesh_resolver(self.mesh, self.activation_rules)

    def param_specs(self, meta_tree):
        from repro_torch.models.params import partition_specs

        return partition_specs(meta_tree, self.param_rules)

    def param_shardings(self, meta_tree):
        return named_sharding_tree(self, self.param_specs(meta_tree))


def make_policy(
    mesh,
    cfg=None,
    *,
    fsdp: bool = True,
    sequence_parallel: bool = False,
    pure_dp: bool = False,
) -> ShardingPolicy:
    """Build the standard 2-D (+pod) policy for this mesh.

    ``fsdp``: additionally shard the embed axis of weight matrices over the
    "data" axis (each unit all-gathers its shards in the forward, and again
    in the backward's recomputation; gradients are reduce-scattered).
    ``sequence_parallel``: shard the residual-stream sequence dim on "model"
    between blocks (the post-block all-reduce becomes a reduce-scatter, and
    an all-gather feeds the next mixer).  ``pure_dp``: batch over every axis
    and FSDP over all of them; no tensor parallelism.
    """
    axis_names = tuple(mesh.mesh_dim_names)
    has_pod = "pod" in axis_names
    dp: Tuple[str, ...] = ("pod", "data") if has_pod else ("data",)
    model_size = mesh.size(axis_names.index("model")) if "model" in axis_names else 1

    if pure_dp:
        all_ax = tuple(axis_names)
        param_rules = {k: (all_ax if k == "embed" and fsdp else None) for k in (
            "vocab", "embed", "mlp", "q_heads", "kv_heads", "head_dim",
            "experts", "expert_mlp", "layers", "state", "conv", "heads",
            "frontend", None,
        )}
        activation_rules = {
            "act_batch": all_ax,
            "act_heads": None, "act_kv_heads": None, "act_mlp": None,
            "act_experts": None, "act_capacity": None, "act_expert_mlp": None,
            "act_vocab": None, "act_q_chunks": None, "act_res_seq": None,
        }
        return ShardingPolicy(mesh, param_rules, activation_rules)

    mode = resolve_attn_mode(cfg, model_size) if cfg is not None else "heads"
    q_rule: object = "model" if mode in ("heads", "q_heads") else None
    kv_rule: object = "model" if mode == "heads" else None
    cp_rule: object = "model" if mode == "cp" else None

    moe_mode = resolve_moe_mode(cfg, model_size) if cfg is not None else "tp"
    exp_rule: object = "model" if moe_mode == "ep" else None
    cap_rule: object = "model" if moe_mode == "capacity" else None

    fs = dp if fsdp else None
    param_rules = {
        "vocab": "model",
        "embed": fs,
        "mlp": "model",
        "q_heads": q_rule,
        "kv_heads": kv_rule,
        "head_dim": None,
        "experts": exp_rule,
        "expert_mlp": None if moe_mode == "capacity" else "model",
        "layers": None,
        "state": None,
        "conv": None,
        "heads": None,
        "frontend": None,
        None: None,
    }

    activation_rules = {
        "act_batch": dp,
        "act_heads": q_rule,
        "act_kv_heads": kv_rule,
        "act_mlp": "model",
        "act_experts": exp_rule,
        "act_capacity": cap_rule,
        "act_expert_mlp": None if moe_mode == "capacity" else "model",
        "act_vocab": "model",
        "act_q_chunks": cp_rule,
        "act_res_seq": "model" if sequence_parallel else None,
    }
    return ShardingPolicy(mesh, param_rules, activation_rules)


def named_sharding_tree(policy: ShardingPolicy, spec_tree):
    return tree_map(lambda s: NamedSharding(policy.mesh, tuple(s)), spec_tree)


def shard_params(params, shardings):
    """Each leaf of the whole tree ``params`` (as ``interop.model_params``
    or ``models.model_params`` make it, the same on every rank) cut to
    this rank's block per ``shardings`` (``policy.param_shardings(meta)``)
    and held in a ``DTensor`` with its placements.  A dim that its mesh axes
    do not divide raises ``ValueError`` naming the leaf and the axes."""
    from torch.distributed.tensor import DTensor

    paths, xs, rebuild = flatten_with_paths(params)
    _, shs, _ = flatten_with_paths(shardings)
    if len(shs) != len(xs):
        raise ValueError(f"{len(shs)} shardings for {len(xs)} parameters")
    out = []
    for path, x, sh in zip(paths, xs, shs):
        local = sh.shard(x.detach(), path)
        out.append(DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                                      shape=x.shape, stride=torch.empty(x.shape, device="meta").stride()))
    return rebuild(out)


def gather_params(params):
    """The inverse of :func:`shard_params`: every ``DTensor`` leaf made whole
    (``comm.full_tensor``, c10d ``all_gather``) on every rank; other leaves
    as they are."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: comm.full_tensor(t) if isinstance(t, DTensor) else t, params)
