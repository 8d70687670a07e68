"""band_reduce_ms: the median device time of stage 1 (``band_reduce`` as
``tridiagonalize`` calls it, kernel A), between CUDA events."""
import statistics


def read(run):
    spans = run.spans.get("band_reduce")
    return 1e3 * statistics.median(spans) if spans else None
