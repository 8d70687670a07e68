"""tridiag_roofline: the two stages' least time on the card (stage 1's and
stage 2's frozen bounds at the call's blocking) over the median time of
the whole ``tridiagonalize`` call between CUDA events, in percent.  It
reads the call, not its kernels, so it stays when a kernel goes."""
import statistics

from evdbench.yardstick import peaks


def read(run):
    spans = run.spans.get("call")
    if not spans:
        return None
    f = run.facts
    bound = peaks.band_reduce_bound_s(f["n"], f["b"], f["nb"]) + peaks.chase_bound_s(f["n"], f["b"])
    return 100.0 * bound / statistics.median(spans)
