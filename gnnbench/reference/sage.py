"""GraphSAGE with the mean aggregator, plain PyTorch (Hamilton et al.
2017): h' = W·[h ; mean over in-neighbours of h] + b, ReLU between
layers, dropout on each layer's input while training. The concatenation
through one weight is PyG SAGEConv's lin_l(mean) + lin_r(h)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .common import dropout, matmul, neighbour_sum

__all__ = ["leaf_shapes", "forward"]


def leaf_shapes(cfg: Dict) -> Dict[str, Tuple[int, ...]]:
    dims = ([cfg["features"]] + [cfg["hidden"]] * (cfg["layers"] - 1)
            + [cfg["classes"]])
    shapes = {}
    for i in range(cfg["layers"]):
        shapes[f"layers.{i}.w"] = (2 * dims[i], dims[i + 1])
        shapes[f"layers.{i}.b"] = (dims[i + 1],)
    return shapes


def forward(params: Dict[str, torch.Tensor], inputs: Dict, cfg: Dict,
            gen=None) -> torch.Tensor:
    """Logits (n, classes); with a generator ``gen``, dropout at the
    configuration's rate before each layer."""
    g = inputs["graph"]
    h = inputs["x"]
    for i in range(cfg["layers"]):
        if gen is not None:
            h = dropout(gen, h, cfg["dropout"])
        mean = neighbour_sum(g, h) / g.in_deg.clamp(min=1.0)[:, None]
        h = matmul(torch.cat([h, mean], dim=-1), params[f"layers.{i}.w"])
        h = h + params[f"layers.{i}.b"]
        if i < cfg["layers"] - 1:
            h = torch.relu(h)
    return h
