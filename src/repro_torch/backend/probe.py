"""Device probe: which device a plan runs on, and whether it is a Hopper card.

The port runs on an NVIDIA H100 unless the caller asks for the CPU.  There
is no silent drop to the CPU: :func:`resolve_device` with no argument means
``"cuda"`` and raises when no card is present.  The CPU is an explicit
choice (``device="cpu"``), which is how the parity tests run the plain
versions of the kernels.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "require_hopper", "device_name"]

HOPPER_CAPABILITY = (9, 0)


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device a plan runs on: ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` for a CUDA device when no card is present.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    return dev


def require_hopper(device: torch.device) -> None:
    """Raise unless ``device`` is a compute capability 9.0 card (H100, H200),
    the kernels' only target."""
    cap = torch.cuda.get_device_capability(device) if device.type == "cuda" else None
    if cap != HOPPER_CAPABILITY:
        raise RuntimeError(
            f"the hand-written kernels are built for sm_90a; device {device} "
            f"has compute capability {cap}"
        )


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
