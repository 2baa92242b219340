"""LGNN, the line graph neural network for community detection on an SBM
(port of ``repro/models/gnn/lgnn.py``).

The app of the paper's §4 framework primitives: BatchNorm1d after every
conv and an Embedding table for the initial node representations, and
two aggregation streams, the node graph G and its line graph L. Layer:

  x' = BN(ρ( x θ1 + (deg·x) θ2 + CR_G(x) θ3 + (P y) θ4 ))
  y' = BN(ρ( y φ1 + (deg_L·y) φ2 + CR_L(y) φ3 + (Pᵀ x) φ4 ))

where P maps line-graph (edge) features back to nodes (``e_copy_add_v``)
and Pᵀ projects node features onto line nodes, per edge e = (u→v) the
endpoint sum x_u + x_v (``u_add_v_copy_e``, B3 ``add`` on the card).

CR_G, P and CR_L run as ONE fused ``hetero_gspmm`` per layer over a
3-relation :class:`~repro_torch.core.hetero.RelGraph` on the disjoint
node ∪ line-node space (:func:`build_relgraph`), θ3 / θ4 / φ3 the
relation-indexed weight stack (B1 over the relation-expanded graph on
the card). Without that RelGraph the three-call path runs, the
differential reference.

:func:`forward` returns ``(logits, bn_state)``: the BatchNorm states the
layers computed (with ``train``, the updated running statistics), as the
JAX forward returns its params with them; :meth:`LGNN.load_bn_state`
writes them into the model's buffers. :func:`train_loss` is the training
loss (for ``train.make_loss_step``): the train-mode forward, its
BatchNorm state written back, the node cross-entropy. Its gradient
reaches the embedding table through the lookup's sorted-segment
backward.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...core.binary_reduce import gsddmm, gspmm
from ...core.graph import Graph, from_coo
from ...core.hetero import (RelGraph, caller_coo, edge_strategy, from_rels,
                            hetero_gspmm, node_strategy)
from ...device import DeviceLike
from ...substrate.batchnorm import BatchNorm1d, batchnorm1d_init
from ...substrate.embedding import embedding_init, embedding_lookup
from ...substrate.nn import cross_entropy_loss, from_numpy, glorot

__all__ = ["LGNN", "LGNNLayer", "init", "build_line_graph",
           "build_relgraph", "forward", "train_loss"]

_WEIGHTS = ("t1", "t2", "t3", "t4", "p1", "p2", "p3", "p4")


class LGNNLayer(nn.Module):
    """θ1–θ4 (``t1``–``t4``), φ1–φ4 (``p1``–``p4``) and the two
    BatchNorms ``bn_x`` / ``bn_y``."""

    def __init__(self, weights: Dict[str, torch.Tensor], bn_x: BatchNorm1d,
                 bn_y: BatchNorm1d):
        super().__init__()
        for k in _WEIGHTS:
            setattr(self, k, nn.Parameter(weights[k]))
        self.bn_x = bn_x
        self.bn_y = bn_y


class LGNN(nn.Module):
    def __init__(self, embed: torch.Tensor, layers: Sequence[LGNNLayer]):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.layers = nn.ModuleList(layers)

    @classmethod
    def from_numpy(cls, tree: Dict, device: DeviceLike = "cuda") -> "LGNN":
        return cls(from_numpy(tree["embed"], device), [
            LGNNLayer({k: from_numpy(p[k], device) for k in _WEIGHTS},
                      BatchNorm1d.from_numpy(p["bn_x"], device),
                      BatchNorm1d.from_numpy(p["bn_y"], device))
            for p in tree["layers"]])

    def load_bn_state(self, bn_state: List[Dict]) -> None:
        """Write :func:`forward`'s returned BatchNorm states into the
        layers' running-statistic buffers."""
        for lyr, st in zip(self.layers, bn_state):
            lyr.bn_x.load_state(st["bn_x"])
            lyr.bn_y.load_state(st["bn_y"])


def build_line_graph(g: Graph, max_out: int = 10_000_000) -> Graph:
    """Line graph: edges of G are nodes of L; e1 → e2 iff dst(e1) =
    src(e2), e2 ≠ e1. L's vertex ids are G's caller edge ids, and its
    edges come in the JAX package's order (G's canonical slots in turn,
    each followed by its destination's out-edges in source-sorted
    order), vectorized on the host; on ``g``'s device."""
    h = g.host
    src = h.src.astype(np.int64)
    dst = h.dst.astype(np.int64)
    eid = h.eid.astype(np.int64)
    # out-edges of every node: canonical slots stably sorted by source
    by_src = eid[np.argsort(src, kind="stable")]
    starts = h.indptr_src.astype(np.int64)[dst]
    counts = h.out_degrees.astype(np.int64)[dst]
    total = int(counts.sum())
    first = np.repeat(np.cumsum(counts) - counts, counts)
    pick = np.repeat(starts, counts) + np.arange(total) - first
    ls = np.repeat(eid, counts)
    ld = by_src[pick]
    keep = ld != ls
    ls, ld = ls[keep], ld[keep]
    if ls.shape[0] >= max_out:
        raise ValueError("line graph too large")
    return from_coo(ls, ld, n_src=g.n_edges, n_dst=g.n_edges,
                    device=g.device)


def build_relgraph(g: Graph, lg: Graph) -> RelGraph:
    """The layer's three aggregation streams as one RelGraph over the
    node space G's nodes (0..n-1) ∪ line nodes (n..n+E-1, by G's caller
    edge id): relation 0 G's edges (CR_G), 1 line node → dst(e) (P), 2
    L's edges (CR_L)."""
    n, E = g.n_dst, g.n_edges
    g_src, g_dst = caller_coo(g)
    l_src, l_dst = caller_coo(lg)
    rels = [(g_src, g_dst),
            (np.arange(E, dtype=np.int64) + n, g_dst),
            (l_src + n, l_dst + n)]
    return from_rels(rels, n_src=n + E, n_dst=n + E, device=g.device)


def init(gen: torch.Generator, n_nodes: int, d_emb: int, d_hidden: int,
         n_classes: int, n_layers: int = 3,
         device: DeviceLike = "cuda") -> LGNN:
    embed = embedding_init(gen, n_nodes, d_emb, device=device)
    layers = []
    dx, dy = d_emb + 1, 1       # node emb + degree; line nodes: degree
    for i in range(n_layers):
        out = n_classes if i == n_layers - 1 else d_hidden
        fan_in = {"t1": dx, "t2": dx, "t3": dx, "t4": dy, "p1": dy,
                  "p2": dy, "p3": dy, "p4": dx}
        weights = {k: glorot(gen, (fan_in[k], out), device)
                   for k in _WEIGHTS}
        layers.append(LGNNLayer(
            weights, BatchNorm1d(batchnorm1d_init(out, device)),
            BatchNorm1d(batchnorm1d_init(out, device))))
        dx, dy = out, out
    return LGNN(embed, layers)


def _fused_aggs(rg: RelGraph, x, y, lyr: LGNNLayer, n: int, strategy: str):
    """agg_x@θ3 + (P y)@θ4 (node rows) and agg_y@φ3 (line rows) as ONE
    fused aggregation over the union space. Features and weights are
    zero-padded to the wider of (dx, dy): padded columns meet zero rows,
    so the sum is exact."""
    dx, dy = lyr.t3.shape[0], lyr.p3.shape[0]
    dmax = max(dx, dy)

    def padf(a, d):
        return a if d == dmax else torch.nn.functional.pad(a, (0, dmax - d))

    def padw(wm, d):
        return wm if d == dmax else torch.nn.functional.pad(
            wm, (0, 0, 0, dmax - d))

    z = torch.cat([padf(x, dx), padf(y, dy)], dim=0)
    w = torch.stack([padw(lyr.t3, dx), padw(lyr.t4, dy), padw(lyr.p3, dy)])
    fused = hetero_gspmm(rg, z, w=w, strategy=strategy)
    return fused[:n], fused[n:]


def forward(model: LGNN, g: Graph, lg: Graph, *,
            rg: Optional[RelGraph] = None, strategy: str = "auto",
            train: bool = True) -> Tuple[torch.Tensor, List[Dict]]:
    """Returns ``(node logits, bn_state)``; ``bn_state[i]`` holds layer
    i's ``bn_x`` / ``bn_y`` states after this call. With ``rg`` (from
    :func:`build_relgraph`) each layer's three aggregation streams run
    as one fused pass; without it, three ``gspmm`` calls."""
    n = g.n_dst
    deg = g.in_degrees.to(model.embed.dtype)[:, None]
    deg_l = lg.in_degrees.to(model.embed.dtype)[:, None]
    ids = torch.arange(n, device=deg.device)
    x = torch.cat([embedding_lookup(model.embed, ids), deg], dim=-1)
    y = deg_l / deg_l.max().clamp(min=1.0)
    plain = node_strategy(strategy)
    bn_state = []
    for lyr in model.layers:
        # Pᵀ x: endpoint sums per edge of G = line-node features, in
        # caller edge order (L's vertex numbering); shared by both paths
        px = gsddmm(g, "u_add_v_copy_e", u=x, v=x,
                    strategy=edge_strategy(strategy))
        if rg is not None:
            xa, ya = _fused_aggs(rg, x, y, lyr, n, strategy)
            xn = x @ lyr.t1 + (deg * x) @ lyr.t2 + xa
            yn = (y @ lyr.p1 + (deg_l * y) @ lyr.p2 + ya + px @ lyr.p4)
        else:
            agg_x = gspmm(g, "u_copy_add_v", u=x, strategy=plain)
            ey = gspmm(g, "e_copy_add_v", e=y, strategy=plain)    # P·y
            xn = (x @ lyr.t1 + (deg * x) @ lyr.t2 + agg_x @ lyr.t3
                  + ey @ lyr.t4)
            agg_y = gspmm(lg, "u_copy_add_v", u=y, strategy=plain)
            yn = (y @ lyr.p1 + (deg_l * y) @ lyr.p2 + agg_y @ lyr.p3
                  + px @ lyr.p4)
        xn, bn_x = lyr.bn_x(torch.relu(xn), train=train)
        yn, bn_y = lyr.bn_y(torch.relu(yn), train=train)
        bn_state.append({"bn_x": bn_x, "bn_y": bn_y})
        x, y = xn, yn
    return x, bn_state


def train_loss(model: LGNN, g: Graph, lg: Graph, labels: torch.Tensor, *,
               rg: Optional[RelGraph] = None,
               strategy: str = "auto") -> torch.Tensor:
    """Cross-entropy of the train-mode forward's node logits against
    ``labels``. The forward's new running statistics are written into
    the model's BatchNorm buffers here, so a training step leaves the
    state that JAX's forward returns in its params."""
    logits, bn_state = forward(model, g, lg, rg=rg, strategy=strategy,
                               train=True)
    model.load_bn_state(bn_state)
    return cross_entropy_loss(logits, labels)
