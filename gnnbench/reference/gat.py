"""GAT, plain PyTorch (Velickovic et al. 2018): per layer z = h·W split
into H heads of F features, e_uv = LeakyReLU(a_l·z_u + a_r·z_v) with
slope 0.2 (and gradient 1 at exactly 0, as the model defines it: on 10⁸
edges a few logits round to 0.0), α the softmax of e over each
destination's in-edges, h'_v = Σ_u α_uv z_u, heads concatenated; ELU
between layers, the last layer one head over the classes; dropout on
each layer's input while training (no dropout on α)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from .common import dropout, edge_softmax, matmul, neighbour_sum

__all__ = ["leaf_shapes", "forward", "leaky_relu"]


def _layers(cfg: Dict):
    d = cfg["features"]
    for i in range(cfg["layers"]):
        last = i == cfg["layers"] - 1
        heads = 1 if last else cfg["heads"]
        out = cfg["classes"] if last else cfg["hidden"]
        yield i, d, heads, out
        d = heads * out


def leaf_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    shapes = {}
    for i, d, heads, out in _layers(cfg):
        shapes[f"layers.{i}.w"] = (d, heads * out)
        shapes[f"layers.{i}.attn_l"] = (heads, out)
        shapes[f"layers.{i}.attn_r"] = (heads, out)
    return shapes


def leaky_relu(e: torch.Tensor, slope: float) -> torch.Tensor:
    """``e`` where ``e`` ≥ 0, else ``slope``·e (gradient 1 at 0, where
    ``torch.nn.functional.leaky_relu``'s is ``slope``)."""
    return torch.where(e >= 0, e, slope * e)


def forward(params: Dict[str, torch.Tensor], inputs: Dict, cfg: Dict,
            gen=None) -> torch.Tensor:
    g = inputs["graph"]
    h = inputs["x"]
    slope = cfg["negative_slope"]
    for i, _, heads, out in _layers(cfg):
        if gen is not None:
            h = dropout(gen, h, cfg["dropout"])
        z = matmul(h, params[f"layers.{i}.w"]).reshape(-1, heads, out)
        el = (z * params[f"layers.{i}.attn_l"]).sum(-1)
        er = (z * params[f"layers.{i}.attn_r"]).sum(-1)
        e = el.index_select(0, g.src) + er.index_select(0, g.dst)
        alpha = edge_softmax(g, leaky_relu(e, slope))
        h = neighbour_sum(g, z, alpha).reshape(-1, heads * out)
        if i < cfg["layers"] - 1:
            h = F.elu(h)
    return h
