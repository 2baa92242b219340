"""GC-MC, graph convolutional matrix completion (port of
``repro/models/gnn/gcmc.py``) — configs ``u_copy_add_v`` and
``u_dot_v_add_e`` (paper Table 2).

A bipartite user→item rating graph with R levels. Encoder: the per-level
aggregations of both directions are TWO fused
:class:`~repro_torch.core.hetero.RelGraph` aggregations, user→item and
item→user, the rating levels as relations and the per-level projections
as the relation-indexed weight stack (B1 over each relation-expanded
graph on the card). Decoder: a bilinear score per observed edge and
level, ``u_dot_v_add_e`` (B3 ``dot``). :func:`encode_loop` keeps the
per-level loop as the baseline and differential reference.

Training: :func:`rating_loss` (the per-rating cross-entropy the JAX
package's tests train by) with ``train.make_loss_step``. Its gradients
run the kernel routes' backwards: B3 ``mul`` per rating and B4 on G and
Gᵀ for the decoder, B1 on each relation-expanded graph's reverse for
the encoder.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ...core.binary_reduce import gsddmm, gspmm
from ...core.graph import Graph, from_coo, reverse
from ...core.hetero import RelGraph, edge_strategy, from_rels, hetero_gspmm
from ...device import DeviceLike
from ...substrate.nn import Linear, cross_entropy_loss, from_numpy, glorot

__all__ = ["GCMC", "init", "build_level_relgraphs", "build_level_graphs",
           "encode", "encode_loop", "decode", "forward", "rating_loss"]


class GCMC(nn.Module):
    """The JAX leaves: ``w_user`` / ``w_item`` one (d, d_hidden) matrix per
    level, ``fc_user`` / ``fc_item`` linear layers, ``q`` (levels, d_out,
    d_out)."""

    def __init__(self, w_user: Sequence[torch.Tensor],
                 w_item: Sequence[torch.Tensor], fc_user: Linear,
                 fc_item: Linear, q: torch.Tensor):
        super().__init__()
        self.w_user = nn.ParameterList(w_user)
        self.w_item = nn.ParameterList(w_item)
        self.fc_user = fc_user
        self.fc_item = fc_item
        self.q = nn.Parameter(q)

    @classmethod
    def from_numpy(cls, tree: Dict, device: DeviceLike = "cuda") -> "GCMC":
        return cls([from_numpy(w, device) for w in tree["w_user"]],
                   [from_numpy(w, device) for w in tree["w_item"]],
                   Linear.from_numpy(tree["fc_user"], device),
                   Linear.from_numpy(tree["fc_item"], device),
                   from_numpy(tree["q"], device))


def _level_edges(u, i, r, levels: int):
    """Per rating level ``(src, dst)`` pairs, caller edge order."""
    u, i, r = (np.asarray(a) for a in (u, i, r))
    return [(u[r == lv], i[r == lv]) for lv in range(levels)]


def build_level_relgraphs(u, i, r, n_users: int, n_items: int, levels: int,
                          device: DeviceLike = "cuda"
                          ) -> Tuple[RelGraph, RelGraph]:
    """The encoder's two fused structures: rating levels as relations,
    user→item and item→user as separate RelGraphs."""
    edges = _level_edges(u, i, r, levels)
    fwd = from_rels(edges, n_src=n_users, n_dst=n_items, device=device)
    bwd = from_rels([(d, s) for s, d in edges], n_src=n_items,
                    n_dst=n_users, device=device)
    return fwd, bwd


def build_level_graphs(u, i, r, n_users: int, n_items: int, levels: int,
                       device: DeviceLike = "cuda"):
    """Per rating level: the user→item Graph and its reverse (the
    structures of :func:`encode_loop`)."""
    fwd, bwd = [], []
    for src, dst in _level_edges(u, i, r, levels):
        g = from_coo(src, dst, n_src=n_users, n_dst=n_items, device=device)
        fwd.append(g)
        bwd.append(reverse(g))
    return fwd, bwd


def init(gen: torch.Generator, d_user: int, d_item: int, d_hidden: int,
         d_out: int, levels: int, device: DeviceLike = "cuda") -> GCMC:
    w_user = [glorot(gen, (d_user, d_hidden), device) for _ in range(levels)]
    w_item = [glorot(gen, (d_item, d_hidden), device) for _ in range(levels)]
    fc_user = Linear.init(gen, d_hidden, d_out, device=device)
    fc_item = Linear.init(gen, d_hidden, d_out, device=device)
    q = (torch.randn(levels, d_out, d_out, generator=gen) * 0.05).to(
        fc_user.w.device)
    return GCMC(w_user, w_item, fc_user, fc_item, q)


def encode(model: GCMC, fwd: RelGraph, bwd: RelGraph, x_user: torch.Tensor,
           x_item: torch.Tensor, *, strategy: str = "auto"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused encoder: each direction is ONE ``hetero_gspmm``, the
    per-level projections the relation-indexed weight stack."""
    h_item = hetero_gspmm(fwd, x_user, w=torch.stack(list(model.w_user)),
                          reduce="mean", strategy=strategy)
    h_user = hetero_gspmm(bwd, x_item, w=torch.stack(list(model.w_item)),
                          reduce="mean", strategy=strategy)
    return (model.fc_user(torch.relu(h_user)),
            model.fc_item(torch.relu(h_item)))


def encode_loop(model: GCMC, fwd: Sequence[Graph], bwd: Sequence[Graph],
                x_user: torch.Tensor, x_item: torch.Tensor, *,
                strategy: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """The pre-fusion reference: one mean CR per level per direction,
    under ``strategy`` (a gspmm strategy)."""
    h_item = h_user = 0.0
    for lv in range(len(fwd)):
        h_item = h_item + gspmm(fwd[lv], "u_copy_mean_v",
                                u=x_user @ model.w_user[lv],
                                strategy=strategy)
        h_user = h_user + gspmm(bwd[lv], "u_copy_mean_v",
                                u=x_item @ model.w_item[lv],
                                strategy=strategy)
    return (model.fc_user(torch.relu(h_user)),
            model.fc_item(torch.relu(h_item)))


def decode(model: GCMC, g_all: Graph, h_user: torch.Tensor,
           h_item: torch.Tensor, *, strategy: str = "auto") -> torch.Tensor:
    """Per observed edge, logits over the rating levels: one
    ``u_dot_v_add_e`` per level (B3 ``dot`` on the card). (n_edges,
    levels) in caller edge order."""
    st = edge_strategy(strategy)
    return torch.stack([gsddmm(g_all, "u_dot_v_add_e", u=h_user @ q,
                               v=h_item, strategy=st)[:, 0]
                        for q in model.q], dim=-1)


def forward(model: GCMC, graphs, x_user: torch.Tensor, x_item: torch.Tensor,
            *, strategy: str = "auto") -> torch.Tensor:
    """``graphs = (fwd, bwd, g_all)``: RelGraphs run the fused encoder,
    per-level Graph lists the loop (their ``strategy`` a gspmm one)."""
    fwd, bwd, g_all = graphs
    if isinstance(fwd, RelGraph):
        hu, hi = encode(model, fwd, bwd, x_user, x_item, strategy=strategy)
    else:
        hu, hi = encode_loop(model, fwd, bwd, x_user, x_item,
                             strategy=strategy)
    return decode(model, g_all, hu, hi, strategy=strategy)


def rating_loss(model: GCMC, graphs, x_user: torch.Tensor,
                x_item: torch.Tensor, ratings: torch.Tensor, *,
                strategy: str = "auto") -> torch.Tensor:
    """Mean cross-entropy of :func:`forward`'s per-edge logits against
    each observed edge's rating level (caller edge order)."""
    return cross_entropy_loss(forward(model, graphs, x_user, x_item,
                                      strategy=strategy), ratings)
