"""repro_torch.parallel — the port's multi-device plumbing on
``torch.distributed``: ``comm`` (mesh-axis groups, the plain and the
autograd collectives, ``run_ranks``), ``hints`` (``shard_hint``,
``hint_resolver``, ``make_mesh_resolver``: the JAX package's activation
hints, here where a tensor's layout changes) and ``sharding`` (the rule
tables, ``ShardingPolicy``, ``make_policy``, the attention and MoE mode
resolvers, and ``shard_params`` / ``gather_params``, which cut a whole
parameter tree into this rank's DTensor-held blocks and back)."""
from .comm import all_gather_rows, all_reduce_sum, axes_group, full_tensor, run_ranks
from .hints import hint_resolver, make_mesh_resolver, shard_hint
from .sharding import (
    NamedSharding,
    ShardingPolicy,
    gather_params,
    make_policy,
    named_sharding_tree,
    resolve_attn_mode,
    resolve_moe_mode,
    shard_params,
)

__all__ = [
    "axes_group", "all_gather_rows", "all_reduce_sum", "full_tensor", "run_ranks",
    "shard_hint", "hint_resolver", "make_mesh_resolver",
    "ShardingPolicy", "NamedSharding", "make_policy", "named_sharding_tree", "resolve_attn_mode",
    "resolve_moe_mode", "shard_params", "gather_params",
]
