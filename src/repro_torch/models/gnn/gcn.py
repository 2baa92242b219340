"""GCN (Kipf & Welling), full-graph forward (port of
``repro/models/gnn/gcn.py``).

H^{l+1} = σ( D^{-1/2} (A+I) D^{-1/2} H^l W^l )

The symmetric normalization is folded into per-edge scalar weights
(``bundle.gcn_norm``), so the hot op is ``u_mul_e_add_v`` with a scalar
edge operand — the weighted Copy-Reduce kernel (B1) on the card.
Dropout and the training paths come with the training slice (A7).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ...core.binary_reduce import gspmm
from ...device import DeviceLike
from ...substrate.nn import Linear
from .common import GraphBundle

__all__ = ["GCN", "init", "forward", "infer"]


class GCN(nn.Module):
    """Stack of ``Linear`` → weighted aggregation, relu between layers."""

    def __init__(self, layers: Sequence[Linear]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    @classmethod
    def from_numpy(cls, tree: Dict, device: DeviceLike = "cuda") -> "GCN":
        return cls([Linear.from_numpy(p, device) for p in tree["layers"]])

    def forward(self, bundle: GraphBundle, x: torch.Tensor, *,
                strategy: str = "auto") -> torch.Tensor:
        h = x
        for i, lyr in enumerate(self.layers):
            h = gspmm(bundle.g, "u_mul_e_add_v", u=lyr(h),
                      e=bundle.gcn_norm[:, None], strategy=strategy)
            if i < len(self.layers) - 1:
                h = torch.relu(h)
        return h


def init(gen: torch.Generator, d_in: int, d_hidden: int, n_classes: int,
         n_layers: int = 2, device: DeviceLike = "cuda") -> GCN:
    dims = [d_in] + [d_hidden] * (n_layers - 1) + [n_classes]
    return GCN([Linear.init(gen, dims[i], dims[i + 1], device=device)
                for i in range(n_layers)])


def forward(model: GCN, bundle: GraphBundle, x: torch.Tensor, *,
            strategy: str = "auto") -> torch.Tensor:
    return model(bundle, x, strategy=strategy)


def infer(model: GCN, bundle: GraphBundle, x: torch.Tensor, *,
          strategy: str = "auto") -> torch.Tensor:
    """Inference-mode forward — the serving tier's layer-wise refresh
    entry point (no autograd graph, so the kernels can launch)."""
    with torch.no_grad():
        return forward(model, bundle, x, strategy=strategy)
