"""Production and local meshes (port of ``repro.launch.mesh``).

Functions, never module-level constants: importing this module touches no
process group.  A mesh spans the initialized ``torch.distributed`` world,
one rank per device.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from repro_torch.backend.compat import make_mesh

__all__ = ["make_production_mesh", "make_local_mesh", "SINGLE_POD", "MULTI_POD"]

SINGLE_POD = (16, 16)
MULTI_POD = (2, 16, 16)


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 ranks over ``("data", "model")``; with ``multi_pod``,
    2 x 16 x 16 = 512 over ``("pod", "data", "model")``, on CUDA.  The
    world must hold exactly that many ranks (``make_mesh`` raises
    otherwise)."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_local_mesh(model: int = 1, *, device_type: Optional[str] = None):
    """A ``(world // model, model)`` mesh over ``("data", "model")`` on
    whatever ranks the initialized world holds (tests, examples)."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else model
    if model < 1 or world % model:
        raise ValueError(f"model={model} must divide the world size {world}")
    return make_mesh((world // model, model), ("data", "model"), device_type=device_type)
