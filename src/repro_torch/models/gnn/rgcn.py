"""R-GCN, relational GCN (port of ``repro/models/gnn/rgcn.py``).

h'_v = σ( W_0 h_v + Σ_r Σ_{u∈N_r(v)} (1/c_{v,r}) W_r h_u )

with the basis decomposition ``W_r = Σ_b coeff[r, b] basis[b]``. All
relations run as ONE fused aggregation over a
:class:`~repro_torch.core.hetero.RelGraph` (``hetero_gspmm`` with
``basis`` / ``coeff`` and the per-relation mean): on the card, B1 over
the relation-expanded graph. :func:`forward_loop` keeps the per-relation
loop of ``gspmm`` calls as the baseline and differential reference. The
sampled path (:func:`forward_blocks`, the serving tier's fan-out) tags
each sampled edge with its relation (``SampledBlock.rel`` / ``rel_norm``)
and fuses every relation per block with ``hetero_block_gspmm`` (B4 on
the card).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ...core.binary_reduce import gspmm
from ...core.graph import Graph, from_coo
from ...core.hetero import (RelGraph, from_rels, hetero_block_gspmm,
                            hetero_gspmm)
from ...device import DeviceLike
from ...substrate.nn import from_numpy, glorot, matmul
from .common import run_blocks

__all__ = ["RGCN", "RGCNLayer", "init", "build_relgraph", "merged_graph",
           "forward", "forward_loop", "block_layer", "forward_blocks",
           "infer", "infer_blocks"]


class RGCNLayer(nn.Module):
    """``basis`` (B, d_in, d_out), ``coeff`` (n_rel, B), ``self``
    (d_in, d_out): the JAX layer's leaves."""

    def __init__(self, basis: torch.Tensor, coeff: torch.Tensor,
                 self_w: torch.Tensor):
        super().__init__()
        self.basis = nn.Parameter(basis)
        self.coeff = nn.Parameter(coeff)
        # "self" is the JAX leaf's name; the attribute must be set this way
        self.register_parameter("self", nn.Parameter(self_w))

    @property
    def self_w(self) -> torch.Tensor:
        return self._parameters["self"]

    def w_rel(self) -> torch.Tensor:
        """(n_rel, d_in, d_out) composed per-relation weights."""
        return torch.einsum("rb,bio->rio", self.coeff, self.basis)


class RGCN(nn.Module):
    def __init__(self, layers: Sequence[RGCNLayer]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    @classmethod
    def from_numpy(cls, tree: Dict, device: DeviceLike = "cuda") -> "RGCN":
        return cls([RGCNLayer(*(from_numpy(p[k], device)
                                for k in ("basis", "coeff", "self")))
                    for p in tree["layers"]])


def init(gen: torch.Generator, d_in: int, d_hidden: int, n_classes: int,
         n_rel: int, n_bases: int = 4, n_layers: int = 2,
         device: DeviceLike = "cuda") -> RGCN:
    layers = []
    d = d_in
    for i in range(n_layers):
        out = n_classes if i == n_layers - 1 else d_hidden
        basis = glorot(gen, (n_bases, d, out), device)
        coeff = (torch.randn(n_rel, n_bases, generator=gen) * 0.3).to(
            basis.device)
        layers.append(RGCNLayer(basis, coeff, glorot(gen, (d, out), device)))
        d = out
    return RGCN(layers)


def build_relgraph(rels: Sequence, n: int,
                   device: DeviceLike = "cuda") -> RelGraph:
    """BGS-like typed graph from per-relation ``(src, dst)`` pairs."""
    return from_rels(list(rels), n_src=n, n_dst=n, device=device)


def merged_graph(rels: Sequence, n: int, device: DeviceLike = "cuda"):
    """Flat (untyped) merged graph + caller-order relation ids — what the
    relational :class:`~repro_torch.data.NeighborSampler` consumes."""
    src = np.concatenate([np.asarray(s, np.int64) for s, _ in rels])
    dst = np.concatenate([np.asarray(d, np.int64) for _, d in rels])
    rel = np.concatenate([np.full(len(np.asarray(s)), r, np.int64)
                          for r, (s, _) in enumerate(rels)])
    return from_coo(src, dst, n_src=n, n_dst=n, device=device), rel


def forward(model: RGCN, rg, x: torch.Tensor, *, strategy: str = "auto",
            train: bool = False,
            gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Full-graph forward over a :class:`RelGraph` (the fused path); a
    sequence of per-relation ``Graph``s goes to :func:`forward_loop`."""
    if not isinstance(rg, RelGraph):
        return forward_loop(model, rg, x, strategy=strategy)
    h = x
    n_layers = len(model.layers)
    for i, lyr in enumerate(model.layers):
        h = (matmul(h, lyr.self_w)
             + hetero_gspmm(rg, h, basis=lyr.basis, coeff=lyr.coeff,
                            reduce="mean", strategy=strategy))
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def forward_loop(model: RGCN, rel_graphs: Sequence[Graph], x: torch.Tensor,
                 *, strategy: str = "auto") -> torch.Tensor:
    """The pre-fusion reference: one mean CR per relation, R ``gspmm``
    calls under ``strategy`` (a gspmm strategy)."""
    h = x
    n_layers = len(model.layers)
    for i, lyr in enumerate(model.layers):
        w_rel = lyr.w_rel()
        acc = matmul(h, lyr.self_w)
        for r, g in enumerate(rel_graphs):
            acc = acc + gspmm(g, "u_copy_mean_v", u=matmul(h, w_rel[r]),
                              strategy=strategy)
        h = acc
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def block_layer(lyr: RGCNLayer, blk, h: torch.Tensor, *,
                strategy: str = "auto",
                bwd_strategy: str = "auto") -> torch.Tensor:
    """One R-GCN layer on a sampled relational block: the self loop on
    the destinations' own features plus ONE fused relation-indexed
    aggregation (``blk.rel`` the sampled edges' relations, ``blk.rel_norm``
    the per-(dst, relation) sampled-mean weights)."""
    if blk.rel is None:
        raise ValueError("R-GCN blocks need relation ids: sample with "
                         "NeighborSampler(..., edge_rel=...)")
    bg = blk.bg
    agg = hetero_block_gspmm(bg, blk.rel, h, lyr.w_rel(), norm=blk.rel_norm,
                             strategy=strategy, bwd_strategy=bwd_strategy)
    return matmul(h[: bg.n_dst_real], lyr.self_w) + agg


def forward_blocks(model: RGCN, blocks, x: torch.Tensor, *,
                   strategy: str = "auto", bwd_strategy: str = "auto",
                   train: bool = False,
                   gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Sampled minibatch forward on the shared ``run_blocks`` path."""
    return run_blocks(block_layer, model.layers, blocks, x,
                      strategy=strategy, bwd_strategy=bwd_strategy,
                      activation=torch.relu, train=train, gen=gen)


def infer(model: RGCN, rg, x: torch.Tensor, *,
          strategy: str = "auto") -> torch.Tensor:
    """Inference-mode forward — the serving tier's layer-wise refresh
    (no autograd graph, so the kernels can launch)."""
    with torch.no_grad():
        return forward(model, rg, x, strategy=strategy)


def infer_blocks(model: RGCN, blocks, x: torch.Tensor, *,
                 strategy: str = "auto") -> torch.Tensor:
    """Inference-mode relational block forward — the fan-out path."""
    with torch.no_grad():
        return forward_blocks(model, blocks, x, strategy=strategy)
