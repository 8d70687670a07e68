"""Device probe and kernel registry of the PyTorch port."""
from . import probe, registry

__all__ = ["probe", "registry"]
