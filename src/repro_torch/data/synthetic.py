"""Synthetic node-classification datasets (port of
``repro/data/synthetic.py``, the R-MAT node presets).

The generators are host numpy, identical to the JAX package's, so a seed
gives the same arrays in both packages: the R-MAT node presets, and the
SBM (LGNN), bipartite rating (GC-MC) and typed multigraph (R-GCN)
generators of the relational apps. ``planted_node_labels`` smooths
features through the port's own ``copy_reduce`` on the graph's device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.binary_reduce import copy_reduce
from ..core.graph import Graph, add_self_loops, from_coo
from ..device import DeviceLike

__all__ = ["rmat_graph", "sbm_graph", "bipartite_ratings",
           "relational_graph", "planted_node_labels", "DATASETS",
           "make_node_dataset"]


def rmat_graph(n_log2: int, n_edges: int, seed: int = 0,
               a=0.57, b=0.19, c=0.19) -> Tuple[np.ndarray, np.ndarray, int]:
    """Vectorized R-MAT generator (power-law, Graph500-style)."""
    rng = np.random.default_rng(seed)
    n = 1 << n_log2
    d = 1.0 - a - b - c
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    for _ in range(n_log2):
        r = rng.random(n_edges)
        src_bit = (r >= a + b).astype(np.int64)
        r2 = rng.random(n_edges)
        dst_bit = np.where(src_bit == 0, (r2 >= a / (a + b)),
                           (r2 >= c / (c + d))).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    # dedup + drop self loops to look like a simple graph
    keep = src != dst
    src, dst = src[keep], dst[keep]
    pairs = np.unique(src * n + dst)
    return (pairs // n, pairs % n, n)


def sbm_graph(n: int, k: int, p_in: float, p_out: float, seed: int = 0
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stochastic block model. Returns (src, dst, communities)."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, k, n)
    # dense Bernoulli is fine at LGNN scales (n <= few thousand)
    probs = np.where(comm[:, None] == comm[None, :], p_in, p_out)
    adj = rng.random((n, n)) < probs
    np.fill_diagonal(adj, False)
    src, dst = np.nonzero(adj)
    return src.astype(np.int64), dst.astype(np.int64), comm


def bipartite_ratings(n_users: int, n_items: int, n_ratings: int,
                      levels: int = 5, seed: int = 0):
    """MovieLens-like random bipartite rating graph, ratings planted from
    latent user / item factors. Returns (u, i, r) with r in [0, levels)."""
    rng = np.random.default_rng(seed)
    pairs = rng.choice(n_users * n_items, size=n_ratings, replace=False)
    u, i = pairs // n_items, pairs % n_items
    fu = rng.normal(size=(n_users, 8))
    fi = rng.normal(size=(n_items, 8))
    score = np.einsum("ud,ud->u", fu[u], fi[i])
    edges = np.quantile(score, np.linspace(0, 1, levels + 1)[1:-1])
    r = np.digitize(score, edges)
    return u.astype(np.int64), i.astype(np.int64), r.astype(np.int64)


def relational_graph(n: int, n_rel: int, edges_per_rel: int, seed: int = 0):
    """BGS-like typed multigraph: list of (src, dst) per relation."""
    rng = np.random.default_rng(seed)
    rels = []
    for _ in range(n_rel):
        src = rng.integers(0, n, edges_per_rel)
        dst = rng.integers(0, n, edges_per_rel)
        rels.append((src, dst))
    return rels


def planted_node_labels(g: Graph, feats: np.ndarray, n_classes: int,
                        seed: int = 0) -> np.ndarray:
    """Labels = argmax of (one-hop-smoothed features) @ random projection,
    so every GNN has a learnable signal."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(g.device)
    with torch.no_grad():
        smooth = copy_reduce(g, x, "mean").cpu().numpy()
    w = rng.normal(size=(feats.shape[1], n_classes))
    logits = (feats[: g.n_dst] + smooth) @ w
    return np.argmax(logits, axis=1).astype(np.int64)


# preset -> (n_log2, edges, n_feat, n_classes) | stands in for paper dataset
DATASETS: Dict[str, dict] = {
    "pubmed-like": dict(n_log2=14, edges=45_000, n_feat=500, n_classes=3,
                        stands_for="Pubmed (19.7k nodes / 44k edges)"),
    "reddit-like": dict(n_log2=16, edges=600_000, n_feat=602, n_classes=41,
                        stands_for="Reddit (233k/11.6M, scaled ~16x down)"),
    "products-like": dict(n_log2=17, edges=1_200_000, n_feat=100,
                          n_classes=47,
                          stands_for="OGB-Products (2.4M/124M, scaled)"),
    "tiny": dict(n_log2=9, edges=3_000, n_feat=32, n_classes=5,
                 stands_for="smoke tests"),
}


def make_node_dataset(preset: str, seed: int = 0, self_loops: bool = True,
                      device: DeviceLike = "cuda"):
    """Returns (Graph on ``device``, feats f32 (n, d) numpy, labels (n,),
    train/val masks, n_classes) — the JAX package's tuple."""
    cfg = DATASETS[preset]
    src, dst, n = rmat_graph(cfg["n_log2"], cfg["edges"], seed=seed)
    if self_loops:
        src, dst = add_self_loops(src, dst, n)
    g = from_coo(src, dst, n_src=n, n_dst=n, device=device)
    rng = np.random.default_rng(seed + 1)
    feats = rng.normal(size=(n, cfg["n_feat"])).astype(np.float32)
    labels = planted_node_labels(g, feats, cfg["n_classes"], seed=seed + 2)
    mask = rng.random(n)
    train_mask = mask < 0.6
    val_mask = (mask >= 0.6) & (mask < 0.8)
    return g, feats, labels, train_mask, val_mask, cfg["n_classes"]
