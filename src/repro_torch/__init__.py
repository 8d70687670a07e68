"""repro_torch — the PyTorch / NVIDIA H100 port of the two-stage symmetric EVD.

A package beside ``repro`` (the JAX reference, which it never imports).
Layout mirrors ``repro``: ``backend`` (device probe, kernel registry),
``kernels`` (hand-written CUDA kernels for sm_90a and their launchers),
``core`` (the pipeline stages), ``solver`` (the plan API), plus
``interop`` (JAX-made factor structures in, as numpy).

    import torch
    from repro_torch.solver import EvdConfig, plan

    w, V = plan(4096, torch.float32, EvdConfig())(A)   # A on "cuda"
"""
__all__ = ["backend", "core", "kernels", "solver", "interop"]
