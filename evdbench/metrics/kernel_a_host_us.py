"""kernel_a_host_us: the mean host time of one call of kernel A's registry
op, the program's ``op.fused_panel_update`` span (``repro_torch.backend.
trace``: the Python, buffers, workspace query and the 4q+1 launches of one
DBR block), over the calls the profiler traced, in microseconds.  A program
without the recorder gives nothing to read."""
import statistics


def read(run):
    from repro_torch.backend import trace

    session = getattr(trace, "session", None)
    us = session().host_us("op.fused_panel_update") if session else []
    return statistics.fmean(us) if us else None
