"""repro_torch.train — the train step and the fault-tolerant training loop
(port of ``repro.train``; the serve-path steps are not ported yet)."""
from .step import chunked_cross_entropy, cross_entropy, make_loss_fn, make_train_step
from .loop import TrainLoop, TrainLoopConfig

__all__ = [
    "cross_entropy",
    "chunked_cross_entropy",
    "make_loss_fn",
    "make_train_step",
    "TrainLoop",
    "TrainLoopConfig",
]
