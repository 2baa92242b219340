"""Small NN building blocks (port of ``repro/substrate/nn.py``): the
initializers, ``Linear``, leaky-relu, and what training adds to them —
dropout drawn from an explicit ``torch.Generator``, the masked
cross-entropy loss and accuracy."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device

__all__ = ["glorot", "he_normal", "from_numpy", "promote", "matmul",
           "einsum", "Linear", "leaky_relu", "dropout", "cross_entropy_loss",
           "accuracy"]


def glorot(gen: torch.Generator, shape: Sequence[int],
           device: DeviceLike = "cuda") -> torch.Tensor:
    """Glorot-uniform on ``(fan_in, ..., fan_out)``, drawn on the CPU
    from ``gen`` (so a seed gives the same weights on every device)."""
    dev = resolve_device(device)
    lim = math.sqrt(6.0 / (shape[0] + shape[-1]))
    w = torch.rand(tuple(shape), generator=gen) * (2 * lim) - lim
    return w.to(dev)


def he_normal(gen: torch.Generator, shape: Sequence[int],
              device: DeviceLike = "cuda") -> torch.Tensor:
    """Normal with std sqrt(2 / fan_in), drawn on the CPU from ``gen``."""
    dev = resolve_device(device)
    std = math.sqrt(2.0 / shape[0])
    return (torch.randn(tuple(shape), generator=gen) * std).to(dev)


def from_numpy(a, device: DeviceLike = "cuda") -> torch.Tensor:
    """A float32 COPY of host array ``a`` on ``device`` (never a view of
    the caller's buffer, which may be read-only or owned elsewhere)."""
    return torch.tensor(np.asarray(a, np.float32),
                        device=resolve_device(device))


def promote(*ts: torch.Tensor) -> tuple:
    """``ts`` cast to their common dtype under JAX's (and PyTorch's)
    promotion rules — bf16 with fp32 is fp32 — for the products, which in
    PyTorch take a single dtype where ``jnp.matmul`` / ``jnp.einsum``
    promote. Tensors already of that dtype pass as they are."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the operands' promoted dtype (:func:`promote`)."""
    a, b = promote(a, b)
    return a @ b


def einsum(eq: str, *ts: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` in the operands' promoted dtype (:func:`promote`)."""
    return torch.einsum(eq, *promote(*ts))


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
        y = matmul(x, self.w)
        return y if self.b is None else y + self.b


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def dropout(gen: torch.Generator, x: torch.Tensor, rate: float,
            train: bool) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - ``rate``
    and scaled by 1 / (1 - ``rate``); the mask is drawn from ``gen``,
    which must live on ``x``'s device. ``x`` itself when not ``train`` or
    ``rate <= 0``, as in JAX."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under softmax(``logits``)
    over the rows where ``mask`` is set (divided by max(Σ mask, 1)), or
    over every row."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[..., None].long())[..., 0]
    if mask is not None:
        m = mask.to(nll.dtype)
        return (nll * m).sum() / m.sum().clamp(min=1.0)
    return nll.mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Share of rows (where ``mask`` is set) whose argmax is the label."""
    hit = (logits.argmax(dim=-1) == labels).to(torch.float32)
    if mask is not None:
        m = mask.to(torch.float32)
        return (hit * m).sum() / m.sum().clamp(min=1.0)
    return hit.mean()
