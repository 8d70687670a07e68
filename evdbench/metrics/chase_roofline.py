"""chase_roofline: stage 2's least time on the card (kernel B's frozen
work with its log) over its median measured time, in percent."""
import statistics

from evdbench.yardstick import peaks


def read(run):
    spans = run.spans.get("chase")
    if not spans:
        return None
    return 100.0 * peaks.chase_bound_s(run.facts["n"], run.facts["b"]) / statistics.median(spans)
