"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device on a host without a
    usable GPU raises — the port never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda is not "
            f"available; pass device='cpu' to run the plain versions")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
