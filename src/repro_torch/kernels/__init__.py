"""Hand-written Hopper kernels of the port, their launchers and plain versions.

Importing this package loads no CUDA code: each library is built and
loaded at the first launch (``repro_torch.kernels.cuda_lib``).
"""
from .cuda_lib import device_launch_counts, launch_counts, reset_launch_counts

__all__ = ["launch_counts", "device_launch_counts", "reset_launch_counts"]
