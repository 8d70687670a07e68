"""repro_torch.parallel — the port's multi-device plumbing on
``torch.distributed`` (``comm``: mesh-axis groups, the collectives,
``run_ranks``).  Model sharding (the JAX package's ``parallel.hints`` and
``parallel.sharding``) is not ported yet: ROADMAP Queue 1 item 12(b)."""
from .comm import all_gather_rows, all_reduce_sum, axes_group, full_tensor, run_ranks

__all__ = ["axes_group", "all_gather_rows", "all_reduce_sum", "full_tensor", "run_ranks"]
