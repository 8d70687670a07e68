"""repro_torch.launch — the training and serve launchers (``python -m
repro_torch.launch.train``, ``python -m repro_torch.launch.serve``).
Meshes and the dry-run are not ported yet."""
