"""repro_torch.optim — AdamW baseline, EVD-powered Shampoo, compression.

Port of ``repro.optim``: the same optax-style ``Optimizer(init, update)``
pairs over nested dicts of tensors (``repro_torch.tree``), in float32.
Shampoo's preconditioner refresh is one ``repro_torch.solver.solve_many``
call per side, on kernels A, B and C when the statistics lie on the card.
"""
from .base import Optimizer, apply_updates, global_norm, clip_by_global_norm
from .adamw import adamw, warmup_cosine
from .shampoo import shampoo, ShampooOptions
from .compression import (
    quantize_int8,
    dequantize_int8,
    compressed_psum,
    ef_compress_transform,
)

__all__ = [
    "Optimizer",
    "apply_updates",
    "global_norm",
    "clip_by_global_norm",
    "adamw",
    "warmup_cosine",
    "shampoo",
    "ShampooOptions",
    "quantize_int8",
    "dequantize_int8",
    "compressed_psum",
    "ef_compress_transform",
]
