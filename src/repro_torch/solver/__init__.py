"""repro_torch.solver — the plan API of the PyTorch port.

    from repro_torch.solver import EvdConfig, by_count, plan, solve_many

    pl = plan(n, torch.float32, EvdConfig(spectrum=by_count(8)))  # on "cuda"
    w, V = pl(A)
    X = solve_many(stats, EvdConfig(b=8, nb=64), op="inverse_pth_root", p=4)

``__all__`` is the JAX package's ``repro.solver.__all__`` less two names:
``trace_count`` (eager torch has no trace to count) and ``tile_defaults``
(the port's tile sizes live in ``repro_torch.kernels.limits``).
"""
from .config import EvdConfig, Spectrum, by_count, by_index, full_spectrum
from .autotune import (
    BlockingDecision,
    backtransform_group,
    blocking_defaults,
    resolve_blocking,
)
from .plan import (
    EvdPlan,
    clear_plan_cache,
    plan,
    plan_cache_size,
    plan_for,
    tridiagonalize,
)
from .batch import BatchPlan, PadPolicy, batch_plan
from .executor import solve_many

__all__ = [
    "EvdConfig",
    "Spectrum",
    "by_count",
    "by_index",
    "full_spectrum",
    "BlockingDecision",
    "backtransform_group",
    "blocking_defaults",
    "resolve_blocking",
    "EvdPlan",
    "plan",
    "plan_for",
    "plan_cache_size",
    "clear_plan_cache",
    "tridiagonalize",
    "BatchPlan",
    "PadPolicy",
    "batch_plan",
    "solve_many",
]
