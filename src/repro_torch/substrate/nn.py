"""Small NN building blocks (port of ``repro/substrate/nn.py``, the parts
the serving slice uses). Dropout, cross-entropy and accuracy come with
the training slice (ROADMAP A6)."""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device

__all__ = ["glorot", "from_numpy", "Linear", "leaky_relu"]


def glorot(gen: torch.Generator, shape: Sequence[int],
           device: DeviceLike = "cuda") -> torch.Tensor:
    """Glorot-uniform on ``(fan_in, ..., fan_out)``, drawn on the CPU
    from ``gen`` (so a seed gives the same weights on every device)."""
    dev = resolve_device(device)
    lim = math.sqrt(6.0 / (shape[0] + shape[-1]))
    w = torch.rand(tuple(shape), generator=gen) * (2 * lim) - lim
    return w.to(dev)


def from_numpy(a, device: DeviceLike = "cuda") -> torch.Tensor:
    """A float32 COPY of host array ``a`` on ``device`` (never a view of
    the caller's buffer, which may be read-only or owned elsewhere)."""
    return torch.tensor(np.asarray(a, np.float32),
                        device=resolve_device(device))


class Linear(nn.Module):
    """``y = x @ w + b`` keeping the JAX layout: ``w`` is (d_in, d_out)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor = None):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = None if b is None else nn.Parameter(b)

    @classmethod
    def init(cls, gen: torch.Generator, d_in: int, d_out: int, *,
             device: DeviceLike = "cuda") -> "Linear":
        w = glorot(gen, (d_in, d_out), device)
        return cls(w, torch.zeros(d_out, device=w.device))

    @classmethod
    def from_numpy(cls, p: dict, device: DeviceLike = "cuda") -> "Linear":
        """From a JAX ``{"w": (d_in, d_out), "b": (d_out,)}`` leaf dict."""
        return cls(from_numpy(p["w"], device),
                   from_numpy(p["b"], device) if "b" in p else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w
        return y if self.b is None else y + self.b


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)
