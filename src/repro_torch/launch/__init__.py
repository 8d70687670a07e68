"""repro_torch.launch — the meshes (``launch.mesh``) and the training and
serve launchers (``python -m repro_torch.launch.train``, ``python -m
repro_torch.launch.serve``), and the dry-run (``launch.specs``,
``launch.cache_specs``, ``python -m repro_torch.launch.dryrun``)."""
from .mesh import make_local_mesh, make_production_mesh

__all__ = ["make_production_mesh", "make_local_mesh"]
