"""band_reduce_roofline: stage 1's least time on the card (kernel A's
frozen work at each DBR block of the call's blocking, against the
published peaks) over its median measured time, in percent."""
import statistics

from evdbench.yardstick import peaks


def read(run):
    spans = run.spans.get("band_reduce")
    if not spans:
        return None
    f = run.facts
    return 100.0 * peaks.band_reduce_bound_s(f["n"], f["b"], f["nb"]) / statistics.median(spans)
