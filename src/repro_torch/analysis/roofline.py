"""Three-term roofline of one step on the NVIDIA H100 (port of
``repro.analysis.roofline``, with the card's own constants).

The card: NVIDIA H100 80GB HBM3 (SXM, 700 W; ``nvidia-smi`` reads "NVIDIA
H100 80GB HBM3, 700.00 W"), NVIDIA's data sheet, dense rates:

    compute    989.4 TFLOP/s bf16 per card
    HBM3       3.35 TB/s per card
    NVLink     450 GB/s per direction, for a group inside one 8-card node
    network    50 GB/s (one 400 Gb/s NIC a card), for a group across nodes

    compute term    = walked FLOPs / peak FLOP/s        (per rank)
    memory term     = walked HBM bytes / HBM rate       (per rank)
    collective term = sum over the step's collective groups of
                      their bytes / the group's link rate  (per rank)

The record is rank 0's (``launch.dryrun``), so every term is per device
already.  Ranks fill nodes of 8 in row-major mesh order (rank r sits at the
mesh coordinates of r and on node r // 8), so a group over the mesh axes
``A`` stays inside rank 0's node when the largest rank of rank 0's group is
below 8, and crosses nodes otherwise.  ``MODEL_FLOPS`` uses the 6·N·D rule
(training) or 2·N·B (decode), N the active parameters: config arithmetic,
the JAX package's exactly.
"""
from __future__ import annotations

import math
from typing import Dict

__all__ = ["roofline_terms", "model_flops", "link_rate", "PEAK_FLOPS", "HBM_BW", "NVLINK_BW", "NET_BW",
           "NODE_SIZE"]

PEAK_FLOPS = 989.4e12   # bf16 FLOP/s per card, dense
HBM_BW = 3.35e12        # bytes/s per card
NVLINK_BW = 450e9       # bytes/s per direction, inside a node
NET_BW = 50e9           # bytes/s per card across nodes
NODE_SIZE = 8           # cards a node


def model_flops(cfg, shape_info: Dict, n_chips: int) -> float:
    """Idealized model FLOPs per device for this cell."""
    counts = cfg.param_counts()
    n_active = counts["active"]
    B, S = shape_info["batch"], shape_info["seq"]
    if shape_info["kind"] == "train":
        total = 6.0 * n_active * B * S
    elif shape_info["kind"] == "prefill":
        total = 2.0 * n_active * B * S
    else:  # decode: one token per sequence
        total = 2.0 * n_active * B
    return total / n_chips


def link_rate(mesh: Dict[str, int], axes: str) -> float:
    """Bytes/s of a collective over ``axes`` (mesh axis names joined by
    ``+``) on a mesh ``{name: size}``: NVLink when rank 0's group fits in
    its node, the network otherwise."""
    names = list(mesh)
    sizes = [mesh[a] for a in names]
    strides = [math.prod(sizes[i + 1:]) for i in range(len(names))]
    last = sum((mesh[a] - 1) * strides[names.index(a)] for a in axes.split("+") if a in mesh)
    return NVLINK_BW if last < NODE_SIZE else NET_BW


def roofline_terms(record: Dict, cfg, shape_info: Dict) -> Dict:
    mesh = record["mesh"]
    n_chips = 1
    for v in mesh.values():
        n_chips *= v
    walk = record["walk"]
    flops = walk["flops_per_device"]
    bytes_acc = walk["hbm_bytes_per_device"]
    per_group = record["collectives"]["per_group"]

    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_acc / HBM_BW
    t_coll = sum(b / link_rate(mesh, axes) for axes, b in per_group.items())

    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    step_time = max(t_compute, t_memory, t_coll)  # perfect-overlap bound

    mf = model_flops(cfg, shape_info, n_chips)
    useful_ratio = mf / flops if flops else 0.0
    # Roofline fraction: useful model FLOP/s at the bound step time over
    # the peak FLOP/s.
    mfu_bound = (mf / step_time) / PEAK_FLOPS if step_time > 0 else 0.0

    return {
        **{k: float(v) for k, v in terms.items()},
        "dominant": dominant.replace("_s", ""),
        "bound_step_time_s": float(step_time),
        "model_flops_per_device": float(mf),
        "useful_flop_ratio": float(useful_ratio),
        "roofline_fraction": float(mfu_bound),
        "chips": n_chips,
    }
