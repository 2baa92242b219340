"""GCN (Kipf & Welling), full-graph forward (port of
``repro/models/gnn/gcn.py``).

H^{l+1} = σ( D^{-1/2} (A+I) D^{-1/2} H^l W^l )

The symmetric normalization is folded into per-edge scalar weights
(``bundle.gcn_norm``), so the hot op is ``u_mul_e_add_v`` with a scalar
edge operand — the weighted Copy-Reduce kernel (B1) on the card, on the
full graph and on each sampled block (:func:`forward_blocks`); its
backward is B1 on Gᵀ with the same weights (the JAX package's
``weighted_copy_reduce``). Under ``strategy="ell"`` with a bundle that
has its training graph (``make_bundle(g, training=True)``), or under
``"auto"`` where the cost model prefers the ELL pull
(``GraphBundle.use_training_graph``: on the CPU's row wherever the
padding is low, on the card's never at these shapes), the layer pulls
through ``weighted_copy_reduce``'s ELL route instead, both ways, as the
JAX forward does. ``train=True`` drops out each layer's input,
as in JAX.

:func:`forward_partitioned` is the same model on a vertex-partitioned
graph (``core/partition.py``, the padded layout): each aggregation is a
ring pass (B1 per ring stage on the card), exact, with a delayed halo
(:func:`init_halo`) or with int8 exchanges (:func:`init_comm`), or both.
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
from .common import (GraphBundle, PartitionedBundle, partitioned_aggregate,
                     run_blocks)

__all__ = ["GCN", "init", "forward", "infer", "block_layer",
           "forward_blocks", "infer_blocks", "init_halo", "init_comm",
           "forward_partitioned"]


class GCN(nn.Module):
    """Stack of ``Linear`` → weighted aggregation, relu between layers."""

    def __init__(self, layers: Sequence[Linear]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    @classmethod
    def from_numpy(cls, tree: Dict, device: DeviceLike = "cuda") -> "GCN":
        return cls([Linear.from_numpy(p, device) for p in tree["layers"]])

    def forward(self, bundle: GraphBundle, x: torch.Tensor, *,
                strategy: str = "auto", train: bool = False,
                gen: Optional[torch.Generator] = None,
                drop: float = 0.5) -> torch.Tensor:
        h = x
        for i, lyr in enumerate(self.layers):
            if train and gen is not None:
                h = dropout(gen, h, drop, train)
            h = lyr(h)
            if bundle.use_training_graph(strategy, h.shape[-1]):
                # the ELL pull forward and backward (its custom VJP over
                # Gᵀ's pack)
                h = weighted_copy_reduce(bundle.tg, h,
                                         bundle.gcn_norm[:, None], "ell")
            else:
                h = gspmm(bundle.g, "u_mul_e_add_v", u=h,
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
            strategy: str = "auto", train: bool = False,
            gen: Optional[torch.Generator] = None,
            drop: float = 0.5) -> torch.Tensor:
    """Full-graph forward; with ``train`` and a generator ``gen`` on the
    graph's device, dropout at rate ``drop`` before each layer."""
    return model(bundle, x, strategy=strategy, train=train, gen=gen,
                 drop=drop)


def infer(model: GCN, bundle: GraphBundle, x: torch.Tensor, *,
          strategy: str = "auto") -> torch.Tensor:
    """Inference-mode forward — the serving tier's layer-wise refresh
    entry point (no autograd graph, so the kernels can launch)."""
    with torch.no_grad():
        return forward(model, bundle, x, strategy=strategy)


def block_layer(lyr: Linear, blk, h: torch.Tensor, *,
                strategy: str = "auto",
                bwd_strategy: str = "auto") -> torch.Tensor:
    """One GCN layer on a sampled block: linear, then the weighted sum
    ``u_mul_e_add_v`` with the FULL graph's symmetric normalization
    gathered per sampled edge (``blk.gcn_norm``; pad edges weigh 0).
    With fanout ≥ max in-degree this is exactly the full-graph layer."""
    return block_gspmm(blk.bg, "u_mul_e_add_v", u=lyr(h),
                       e=blk.gcn_norm[:, None], strategy=strategy,
                       bwd_strategy=bwd_strategy)


def forward_blocks(model: GCN, blocks, x: torch.Tensor, *,
                   strategy: str = "auto", bwd_strategy: str = "auto",
                   train: bool = False,
                   gen: Optional[torch.Generator] = None,
                   drop: float = 0.5) -> torch.Tensor:
    """Sampled mini-batch forward on the shared block path; with ``train`` and a generator ``gen`` on the features'
    device, dropout at rate ``drop`` before each layer. ``bwd_strategy``:
    the block VJP (``core/blocks.py``)."""
    return run_blocks(block_layer, model.layers, blocks, x,
                      strategy=strategy, bwd_strategy=bwd_strategy,
                      activation=torch.relu, train=train, gen=gen,
                      drop=drop)


def infer_blocks(model: GCN, blocks, x: torch.Tensor, *,
                 strategy: str = "auto") -> torch.Tensor:
    """Inference-mode block forward — the serving tier's fan-out path."""
    with torch.no_grad():
        return forward_blocks(model, blocks, x, strategy=strategy)


# --------------------------------------------------------------------- #
# partitioned (repro/models/gnn/gcn.py:78-140)
# --------------------------------------------------------------------- #
def init_halo(model: GCN, pg) -> tuple:
    """Zero remote-partial carry for the delayed halo: one fp32 (n_pad,
    d_out) tensor per layer (GCN aggregates after the linear)."""
    return tuple(torch.zeros((pg.n_pad, lyr.w.shape[1]), device=pg.device)
                 for lyr in model.layers)


def init_comm(model: GCN, pg) -> tuple:
    """Zero error-feedback residual of the int8 exchanges: one fp32
    (n_pad, d_out) tensor per layer, the exchanged payload's shape."""
    return init_halo(model, pg)


def forward_partitioned(model: GCN, pb: PartitionedBundle, x: torch.Tensor,
                        *, halo=None, refresh: bool = True, comm_state=None,
                        train: bool = False,
                        gen: Optional[torch.Generator] = None,
                        drop: float = 0.5, strategy: str = "auto"):
    """Full-graph forward on a vertex-partitioned graph. ``x``: (n_pad, d)
    padded (``pg.scatter_nodes``). With ``halo`` (:func:`init_halo`) the
    cross-shard partials are recomputed only when ``refresh`` and reused
    stale otherwise; with ``comm_state`` (:func:`init_comm`) every
    refreshed exchange is int8 with error feedback. Returns
    ``(logits_pad, halo_out)``, or ``(logits_pad, halo_out, comm_out)``
    with ``comm_state``. ``strategy``: ``core/partition.RING_STRATEGIES``.
    """
    h = x
    halo_out, comm_out = [], []
    for i, lyr in enumerate(model.layers):
        if train and gen is not None:
            h = pb.dropout(gen, h, drop, train)
        h, stale, res = partitioned_aggregate(pb, lyr(h), pb.gcn_w, i, halo,
                                              refresh, comm_state, strategy)
        halo_out.append(stale)
        comm_out.append(res)
        if i < len(model.layers) - 1:
            h = torch.relu(h)
    halo_ret = tuple(halo_out) if halo is not None else None
    if comm_state is None:
        return h, halo_ret
    return h, halo_ret, tuple(comm_out)
