"""repro_torch.launch — the training launcher (``python -m
repro_torch.launch.train``).  Meshes, the serve launcher and the dry-run are
not ported yet."""
