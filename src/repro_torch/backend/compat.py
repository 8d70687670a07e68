"""Device meshes (port of ``repro.backend.compat``'s ``make_mesh``).

The JAX package's compat module papers over JAX API drift: ``shard_map``,
TPU Pallas compiler params (``tpu_compiler_params``), ``jax.make_mesh``'s
axis types and ``cost_analysis``.  Only the mesh has a counterpart here.
``shard_map`` has none: the port is multi-controller, so a function that
JAX maps over a mesh is a plain function every rank calls, and its
collectives live in ``repro_torch.parallel.comm``.  There are no TPU
compiler params and no XLA cost analysis.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist

from . import probe

__all__ = ["make_mesh"]


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of shape ``axis_shapes`` with dimensions named
    ``axis_names`` over the initialized process group's ranks (row-major:
    rank r sits at the mesh coordinates of r).

    ``device_type`` ``None`` means ``"cuda"`` (which raises without a
    card), as ``probe.resolve_device`` does; pass ``"cpu"`` for ranks on
    the CPU.  Raises when no process group is initialized, or when the
    world size differs from the product of the shape.
    """
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = tuple(int(s) for s in axis_shapes), tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ in length")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed process group: call "
            "torch.distributed.init_process_group in every rank first (or run under "
            "repro_torch.parallel.run_ranks)"
        )
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} ranks, the world has {world}")
    device_type = probe.resolve_device(device_type).type
    return init_device_mesh(device_type, shape, mesh_dim_names=names)
