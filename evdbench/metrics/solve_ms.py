"""solve_ms: the window's wall time over the single-matrix calls completed
in it, each closed by a synchronize (a caller uses the result)."""


def read(run):
    return 1e3 * run.window_s / run.calls
