"""repro_torch.launch — the meshes (``launch.mesh``) and the training and
serve launchers (``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.serve``).  The dry-run is not ported yet."""
from .mesh import make_local_mesh, make_production_mesh

__all__ = ["make_production_mesh", "make_local_mesh"]
