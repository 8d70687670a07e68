"""Layouts of the decode cache on a mesh (port of
``repro.launch.cache_specs``; mirrors ``models.lm.cache_meta``).

The same rule as the JAX package's, leaf by leaf: the batch on the data
axes (``("pod", "data")`` on a multi-pod mesh) where it divides them, else
replicated; K/V on their heads where the policy splits KV heads, else on
the cache's window (decode context parallelism); the Mamba2 state on its
heads, its conv window on its channels and the RG-LRU state on its width,
all on ``model``; the Mamba2 B/C window and ``pos`` replicated.  Where the
JAX package hands these to ``jax.jit`` as ``in_shardings``, the port cuts
each rank's blocks (:func:`shard_cache`) and the sharded serve step
(``train.make_serve_step(policy=)``) computes on them.
"""
from __future__ import annotations

from repro_torch.models.params import PartitionSpec
from repro_torch.parallel.sharding import NamedSharding
from repro_torch.tree import flatten_with_paths, tree_map

__all__ = ["cache_specs", "cache_partition_specs", "shard_cache"]


def cache_specs(cfg, mesh, policy, cache_tree):
    """A ``PartitionSpec`` per leaf of ``cache_tree`` (``cache_meta``'s
    tree, or any tree of tensors of its shapes)."""
    names = tuple(mesh.mesh_dim_names)
    dp_axes = ("pod", "data") if "pod" in names else ("data",)
    dp_total = 1
    for a in dp_axes:
        dp_total *= mesh.size(names.index(a))
    kv_rule = policy.activation_rules.get("act_kv_heads")

    def spec_for(path: str, t):
        keys = [k[2:-2] for k in path.split("/")]
        name, ndim = keys[-1], t.dim()
        stacked = 1 if "units" in keys else 0
        # The batch dim follows the optional layer-stack dim; tiny decode
        # batches (long_500k has B = 1) replicate instead of splitting.
        batch_size = t.shape[stacked] if ndim > stacked else 1
        dp = (dp_axes if len(dp_axes) > 1 else dp_axes[0]) if batch_size % dp_total == 0 else None
        lead = (None,) * stacked
        if "pos" in name:
            entries = ()
        elif name in ("k", "v"):  # (L?, B, W, hkv, hd)
            entries = (*lead, dp, "model" if kv_rule is None else None, kv_rule, None)
        elif name == "state":  # (L?, B, h, n, P)
            entries = (*lead, dp, "model", None, None)
        elif name == "conv":  # (L?, B, w, ch)
            entries = (*lead, dp, None, "model")
        elif name == "h":  # (L?, B, w)
            entries = (*lead, dp, "model")
        else:
            entries = (None,) * ndim
        entries = list(entries)[:ndim]
        return PartitionSpec(*(entries + [None] * (ndim - len(entries))))

    paths, ts, rebuild = flatten_with_paths(cache_tree)
    return rebuild([spec_for(p, t) for p, t in zip(paths, ts)])


def cache_partition_specs(cfg, mesh, policy, cache_tree):
    """:func:`cache_specs` as ``NamedSharding`` s on ``mesh``."""
    return tree_map(lambda s: NamedSharding(mesh, tuple(s)), cache_specs(cfg, mesh, policy, cache_tree))


def shard_cache(cache, shardings):
    """Each leaf of the whole cache ``cache`` cut to this rank's block per
    ``shardings`` (:func:`cache_partition_specs`): plain tensors, which the
    serve step writes in place."""
    paths, ts, rebuild = flatten_with_paths(cache)
    shs = flatten_with_paths(shardings)[1]
    return rebuild([sh.shard(t, p) for p, t, sh in zip(paths, ts, shs)])
