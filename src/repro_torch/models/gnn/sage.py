"""GraphSAGE (mean aggregator), full-graph forward (port of
``repro/models/gnn/sage.py``).

h'_v = σ(W·[h_v ; mean_{u∈N(v)} h_u]) — the aggregation is
``u_copy_mean_v``, the mean Copy-Reduce kernel (B1) on the card, on the
full graph and on each sampled block (:func:`forward_blocks`); its
backward is B1 on Gᵀ with 1/deg_in folded into the cotangent (the JAX
package's ``weighted_copy_reduce`` with ``mean_norm``), skipped for
layer 0, whose input needs no grad. Under ``strategy="ell"`` with a
bundle that has its training graph (``make_bundle(g, training=True)``),
or under ``"auto"`` where the cost model prefers the ELL pull
(``GraphBundle.use_training_graph``), the mean pulls through
``weighted_copy_reduce``'s ELL route, both ways, as in JAX.
``train=True`` drops out each layer's input. The partitioned variant is
A12.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ...core.binary_reduce import gspmm
from ...core.blocks import block_gspmm
from ...core.training_ops import weighted_copy_reduce
from ...device import DeviceLike
from ...substrate.nn import Linear, dropout
from .common import GraphBundle, run_blocks

__all__ = ["SAGE", "init", "forward", "infer", "block_layer",
           "forward_blocks", "infer_blocks"]


class SAGE(nn.Module):
    """Stack of mean aggregation → ``Linear`` on ``[h ; mean]``."""

    def __init__(self, layers: Sequence[Linear]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    @classmethod
    def from_numpy(cls, tree: Dict, device: DeviceLike = "cuda") -> "SAGE":
        return cls([Linear.from_numpy(p, device) for p in tree["layers"]])

    def forward(self, bundle: GraphBundle, x: torch.Tensor, *,
                strategy: str = "auto", train: bool = False,
                gen: Optional[torch.Generator] = None,
                drop: float = 0.5) -> torch.Tensor:
        h = x
        for i, lyr in enumerate(self.layers):
            if train and gen is not None:
                h = dropout(gen, h, drop, train)
            if bundle.use_training_graph(strategy, h.shape[-1]):
                # mean as the weighted sum by 1/deg_in, pulled over the
                # ELL packs both ways
                hn = weighted_copy_reduce(bundle.tg, h,
                                          bundle.mean_norm[:, None], "ell")
            else:
                hn = gspmm(bundle.g, "u_copy_mean_v", u=h,
                           strategy=strategy)
            h = lyr(torch.cat([h, hn], dim=-1))
            if i < len(self.layers) - 1:
                h = torch.relu(h)
        return h


def init(gen: torch.Generator, d_in: int, d_hidden: int, n_classes: int,
         n_layers: int = 2, device: DeviceLike = "cuda") -> SAGE:
    dims = [d_in] + [d_hidden] * (n_layers - 1) + [n_classes]
    return SAGE([Linear.init(gen, 2 * dims[i], dims[i + 1], device=device)
                 for i in range(n_layers)])


def forward(model: SAGE, bundle: GraphBundle, x: torch.Tensor, *,
            strategy: str = "auto", train: bool = False,
            gen: Optional[torch.Generator] = None,
            drop: float = 0.5) -> torch.Tensor:
    """Full-graph forward; with ``train`` and a generator ``gen`` on the
    graph's device, dropout at rate ``drop`` before each layer."""
    return model(bundle, x, strategy=strategy, train=train, gen=gen,
                 drop=drop)


def infer(model: SAGE, bundle: GraphBundle, x: torch.Tensor, *,
          strategy: str = "auto") -> torch.Tensor:
    """Inference-mode forward — the serving tier's layer-wise refresh
    entry point (no autograd graph, so the kernels can launch)."""
    with torch.no_grad():
        return forward(model, bundle, x, strategy=strategy)


def block_layer(lyr: Linear, blk, h: torch.Tensor, *,
                strategy: str = "auto",
                bwd_strategy: str = "auto") -> torch.Tensor:
    """One SAGE layer on a sampled block: the mean over sampled in-edges
    (pad slots contribute zero) concat the destination's own features
    (dst-first numbering: ``h[:n_dst_real]``)."""
    bg = blk.bg
    hn = block_gspmm(bg, "u_copy_mean_v", u=h, strategy=strategy,
                     bwd_strategy=bwd_strategy)
    return lyr(torch.cat([h[: bg.n_dst_real], hn], dim=-1))


def forward_blocks(model: SAGE, blocks, x: torch.Tensor, *,
                   strategy: str = "auto", bwd_strategy: str = "auto",
                   train: bool = False,
                   gen: Optional[torch.Generator] = None,
                   drop: float = 0.5) -> torch.Tensor:
    """Sampled mini-batch forward (paper Fig. 3) on the shared path; with ``train`` and a generator ``gen`` on the features'
    device, dropout at rate ``drop`` before each layer. ``bwd_strategy``:
    the block VJP (``core/blocks.py``)."""
    return run_blocks(block_layer, model.layers, blocks, x,
                      strategy=strategy, bwd_strategy=bwd_strategy,
                      activation=torch.relu, train=train, gen=gen,
                      drop=drop)


def infer_blocks(model: SAGE, blocks, x: torch.Tensor, *,
                 strategy: str = "auto") -> torch.Tensor:
    """Inference-mode block forward — the serving tier's fan-out path."""
    with torch.no_grad():
        return forward_blocks(model, blocks, x, strategy=strategy)
