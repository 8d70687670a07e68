"""repro_torch.ckpt — atomic, keep-k, async checkpointing."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
