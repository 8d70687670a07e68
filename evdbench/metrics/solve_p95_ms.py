"""solve_p95_ms: the 95th percentile (nearest rank) of the window's
per-call wall times, over every call of the window."""
import math


def read(run):
    times = sorted(run.call_s)
    return 1e3 * times[math.ceil(0.95 * len(times)) - 1]
