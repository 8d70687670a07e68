"""chase_ms: the median device time of stage 2 (``band_to_tridiag`` with
its log, kernel B), between CUDA events."""
import statistics


def read(run):
    spans = run.spans.get("chase")
    return 1e3 * statistics.median(spans) if spans else None
