"""repro_torch.solver — the plan API of the PyTorch port.

    from repro_torch.solver import EvdConfig, by_count, plan

    pl = plan(n, torch.float32, EvdConfig(spectrum=by_count(8)))  # on "cuda"
    w, V = pl(A)
"""
from .config import EvdConfig, Spectrum, by_count, by_index, full_spectrum
from .autotune import (
    BlockingDecision,
    backtransform_group,
    blocking_defaults,
    resolve_blocking,
    wavefront_group,
)
from .plan import EvdPlan, clear_plan_cache, plan, plan_cache_size, plan_for

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
    "wavefront_group",
    "EvdPlan",
    "plan",
    "plan_for",
    "plan_cache_size",
    "clear_plan_cache",
]
