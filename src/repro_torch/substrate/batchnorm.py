"""BatchNorm1d (port of ``repro/substrate/batchnorm.py``, paper §4).

Written out by hand, not ``nn.BatchNorm1d``: the JAX package normalizes
with the batch's *biased* variance and updates its running statistics as
``running = momentum·old + (1 − momentum)·batch`` with that same biased
variance (torch's module keeps the unbiased one), and it returns the new
state instead of updating it in place. :func:`batchnorm1d_apply` is that
function; :class:`BatchNorm1d` holds ``scale`` / ``bias`` as parameters
and the running statistics as buffers, and :meth:`BatchNorm1d.load_state`
writes a returned state back into them.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .nn import from_numpy

__all__ = ["batchnorm1d_init", "batchnorm1d_apply", "BatchNorm1d"]

_STATS = ("running_mean", "running_var")


def batchnorm1d_init(d: int, device: DeviceLike = "cuda"
                     ) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    return {"scale": torch.ones(d, device=dev),
            "bias": torch.zeros(d, device=dev),
            "running_mean": torch.zeros(d, device=dev),
            "running_var": torch.ones(d, device=dev)}


def batchnorm1d_apply(state: Dict[str, torch.Tensor], x: torch.Tensor, *,
                      train: bool = True, momentum: float = 0.9,
                      eps: float = 1e-5
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batch norm over axis 0. Returns ``(y, new_state)``: with ``train``
    the batch's statistics normalize ``x`` and update the running ones
    (detached: they are state, not a function to differentiate); without
    it the running statistics normalize and the state is returned as is."""
    if train:
        mean = x.mean(dim=0)
        var = x.var(dim=0, unbiased=False)
        new_state = dict(state)
        for name, batch in zip(_STATS, (mean, var)):
            new_state[name] = (momentum * state[name]
                               + (1 - momentum) * batch.detach())
    else:
        mean, var = state["running_mean"], state["running_var"]
        new_state = state
    inv = torch.rsqrt(var + eps)
    y = (x - mean) * (inv * state["scale"]) + state["bias"]
    return y.to(x.dtype), new_state


class BatchNorm1d(nn.Module):
    """:func:`batchnorm1d_apply` with ``scale`` / ``bias`` as parameters
    and the running statistics as buffers."""

    def __init__(self, state: Dict[str, torch.Tensor]):
        super().__init__()
        self.scale = nn.Parameter(state["scale"])
        self.bias = nn.Parameter(state["bias"])
        for name in _STATS:
            self.register_buffer(name, state[name])

    @classmethod
    def from_numpy(cls, p: Dict, device: DeviceLike = "cuda"
                   ) -> "BatchNorm1d":
        return cls({k: from_numpy(v, device) for k, v in p.items()})

    def state(self) -> Dict[str, torch.Tensor]:
        return {"scale": self.scale, "bias": self.bias,
                "running_mean": self.running_mean,
                "running_var": self.running_var}

    def forward(self, x: torch.Tensor, *, train: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        return batchnorm1d_apply(self.state(), x, train=train)

    def load_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Write a state's running statistics into the buffers."""
        with torch.no_grad():
            for name in _STATS:
                getattr(self, name).copy_(state[name])
