"""Inputs of a cell, made from ``--seed`` on the run's device.

The graph is R-MAT with the quadrant weights of the port's
``data/synthetic.rmat_graph`` (a = 0.57, b = 0.19, c = 0.19), rewritten
in torch so that it runs on the card: node ids are drawn on
2**ceil(log2 n) and an edge with an id ≥ n is redrawn, self-pairs are
dropped and duplicate pairs merged, draws go on until the configuration's
edge count is reached and exactly that many distinct pairs are kept, at
random. Node ids are then relabelled by a random permutation, so the
hubs are not the lowest ids, and a self-loop is appended for every node.
Caller edge order is random. The same seed gives the same arrays.

Features are standard normal, labels uniform over the classes, and the
train split a random set of ``train_nodes`` nodes. Weights are
Glorot-uniform (biases zero), one call per leaf, on the device.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import torch

__all__ = ["derive_seed", "generator", "rmat_edges", "node_data",
           "glorot_leaves"]


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run (``tag``), from ``seed``."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, tag))


def rmat_edges(n: int, n_edges: int, seed: int, device, *, a: float = 0.57,
               b: float = 0.19, c: float = 0.19, self_loops: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(src, dst)`` int64 on ``device``: ``n_edges`` distinct R-MAT pairs
    between ``n`` nodes (no self-pair), in random caller order, then one
    self-loop per node when ``self_loops``."""
    if n_edges > n * (n - 1):
        raise ValueError(f"{n_edges} distinct edges do not fit {n} nodes")
    gen = generator(seed, "graph", device)
    levels = max(1, math.ceil(math.log2(n)))
    d = 1.0 - a - b - c
    keys = torch.empty(0, dtype=torch.int64, device=device)
    while keys.numel() < n_edges:
        m = int((n_edges - keys.numel()) * 1.3) + 1024
        src = torch.zeros(m, dtype=torch.int64, device=device)
        dst = torch.zeros(m, dtype=torch.int64, device=device)
        for _ in range(levels):
            r = torch.rand(m, generator=gen, device=device)
            s_bit = r >= a + b
            r2 = torch.rand(m, generator=gen, device=device)
            d_bit = torch.where(s_bit, r2 >= c / (c + d), r2 >= a / (a + b))
            src = src * 2 + s_bit
            dst = dst * 2 + d_bit
        ok = (src < n) & (dst < n) & (src != dst)
        keys = torch.unique(torch.cat([keys, src[ok] * n + dst[ok]]))
        del src, dst, ok
    pick = torch.randperm(keys.numel(), generator=gen, device=device)
    keys = keys[pick[:n_edges]]
    label = torch.randperm(n, generator=gen, device=device)
    src, dst = label[keys // n], label[keys % n]
    if self_loops:
        loops = torch.arange(n, device=device)
        src, dst = torch.cat([src, loops]), torch.cat([dst, loops])
    return src, dst


def node_data(n: int, n_features: int, n_classes: int, n_train: int,
              seed: int, device) -> Dict[str, torch.Tensor]:
    """Features (n, n_features) fp32, labels (n,) int64 and the train
    mask (n,) bool, on ``device``."""
    gen = generator(seed, "nodes", device)
    x = torch.randn(n, n_features, generator=gen, device=device)
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=device)
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    mask[torch.randperm(n, generator=gen, device=device)[:n_train]] = True
    return {"x": x, "labels": labels, "train_mask": mask}


def glorot_leaves(shapes: Dict[str, Tuple[int, ...]], seed: int, device
                  ) -> Dict[str, torch.Tensor]:
    """One fp32 tensor per named leaf: Glorot-uniform on (fan_in, ...,
    fan_out) for a leaf of rank ≥ 2, zeros for a rank-1 leaf (a bias)."""
    gen = generator(seed, "weights", device)
    out = {}
    for name, shape in shapes.items():
        if len(shape) == 1:
            out[name] = torch.zeros(shape, device=device)
            continue
        lim = math.sqrt(6.0 / (shape[0] + shape[-1]))
        out[name] = (torch.rand(shape, generator=gen, device=device)
                     * (2 * lim) - lim)
    return out
