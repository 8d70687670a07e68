"""repro_torch.data — deterministic synthetic token pipeline."""
from .pipeline import DataConfig, batch_for, host_batches, synthetic_batch

__all__ = ["DataConfig", "synthetic_batch", "host_batches", "batch_for"]
