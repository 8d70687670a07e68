"""repro_torch.train — the train and serve step builders and the
fault-tolerant training loop (port of ``repro.train``)."""
from .step import (
    chunked_cross_entropy,
    cross_entropy,
    init_opt_state,
    make_loss_fn,
    make_prefill,
    make_serve_step,
    make_train_step,
)
from .loop import TrainLoop, TrainLoopConfig

__all__ = [
    "cross_entropy",
    "chunked_cross_entropy",
    "make_loss_fn",
    "make_train_step",
    "init_opt_state",
    "make_prefill",
    "make_serve_step",
    "TrainLoop",
    "TrainLoopConfig",
]
