"""chase_span_ms: the median device time of the program's own ``chase``
spans (``repro_torch.backend.trace``: stage 2, kernel B, inside each traced
``tridiagonalize`` call, between the CUDA events the span records; host
time on the CPU).  The recorder's session holds the calls the profiler
traced.  A program without the recorder gives nothing to read."""
import statistics


def read(run):
    from repro_torch.backend import trace

    session = getattr(trace, "session", None)
    ms = session().ms("chase") if session else []
    return statistics.median(ms) if ms else None
