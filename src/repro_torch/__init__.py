"""repro_torch — the PyTorch / NVIDIA H100 port of the two-stage symmetric EVD.

A package beside ``repro`` (the JAX reference, which it never imports).
Layout mirrors ``repro``: ``backend`` (device probe, kernel registry),
``kernels`` (hand-written CUDA kernels for sm_90a and their launchers),
``core`` (the pipeline stages), ``solver`` (the plan API), and the
training and serving stack around the solver's consumer, Shampoo:
``optim``, ``models`` (the decoder LM, dense and MoE, with its decode
caches), ``configs``, ``data``, ``train``, ``ckpt`` and ``launch``; plus
``tree`` (nested containers walked as ``jax.tree_util`` walks them) and
``interop`` (JAX-made state in, as numpy).

    import torch
    from repro_torch.solver import EvdConfig, plan

    w, V = plan(4096, torch.float32, EvdConfig())(A)   # A on "cuda"

    python -m repro_torch.launch.train --arch llama3.2-3b --smoke --optimizer shampoo
    python -m repro_torch.launch.serve --arch mixtral-8x7b --smoke
"""
__all__ = [
    "backend", "core", "kernels", "solver", "optim", "models", "configs", "data", "train",
    "ckpt", "launch", "parallel", "tree", "interop",
]
