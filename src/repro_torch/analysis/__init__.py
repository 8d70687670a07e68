"""repro_torch.analysis — what a step costs, counted from its run (port of
``repro.analysis``): ``walk`` (FLOPs, HBM bytes and peak live bytes, op by
op; the counterpart of the HLO walk), ``collectives`` (bytes by kind and by
group, from ``repro_torch.parallel.comm``'s counter; the counterpart of the
HLO collective parse) and ``roofline`` (the three terms against the H100's
peaks)."""
from .collectives import collective_bytes
from .roofline import HBM_BW, NET_BW, NVLINK_BW, PEAK_FLOPS, model_flops, roofline_terms
from .walk import StepWalk, analyze_step

__all__ = ["collective_bytes", "roofline_terms", "model_flops", "PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "NET_BW",
           "StepWalk", "analyze_step"]
