"""Collective bytes of a step, per kind and per group (the port's
counterpart of ``repro.analysis.collectives``).

The JAX package parses them out of post-SPMD HLO.  The port has no HLO:
every collective of a step passes through ``repro_torch.parallel.comm``,
which counts its payload bytes (the bytes the rank hands the collective,
as the JAX package counts operand bytes) by kind and by the mesh axes of
its group.  :func:`collective_bytes` reads that counter.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.parallel import comm

__all__ = ["collective_bytes"]


def collective_bytes() -> Dict:
    """``{"total_bytes", "per_kind": {kind: {"count", "bytes", "by_axes"}},
    "per_group": {axes: bytes}}`` of what ``comm`` counted since its last
    ``reset_traffic()``; ``axes`` are mesh axis names joined by ``+``."""
    per_kind, per_group = {}, {}
    for kind, groups in sorted(comm.kinds.items()):
        per_kind[kind] = {
            "count": sum(g["count"] for g in groups.values()),
            "bytes": sum(g["bytes"] for g in groups.values()),
            "by_axes": {a: dict(g) for a, g in sorted(groups.items())},
        }
        for axes, g in groups.items():
            per_group[axes] = per_group.get(axes, 0) + g["bytes"]
    return {"total_bytes": sum(per_group.values()), "per_kind": per_kind, "per_group": dict(sorted(per_group.items()))}
