"""band_reduce_span_ms: the median device time of the program's own
``band_reduce`` spans (``repro_torch.backend.trace``: stage 1 inside each
traced ``tridiagonalize`` call, between the CUDA events the span records;
host time on the CPU).  The recorder's session holds the calls the profiler
traced.  A program without the recorder gives nothing to read."""
import statistics


def read(run):
    from repro_torch.backend import trace

    session = getattr(trace, "session", None)
    ms = session().ms("band_reduce") if session else []
    return statistics.median(ms) if ms else None
