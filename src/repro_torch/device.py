"""The one rule about where the package runs.

Entry points run on the GPU unless the caller asks for the CPU:
``device=None`` means ``cuda`` and *raises* when no CUDA device is
present — nothing in this package quietly degrades to the CPU.  Tests
and CPU-only callers pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → the current CUDA device (or ``RuntimeError`` when there
    is none); anything else → ``torch.device(device)``, validated."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
