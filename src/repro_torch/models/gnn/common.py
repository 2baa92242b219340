"""Shared GNN plumbing (port of ``repro/models/gnn/common.py``, the
full-graph parts): the graph bundle with its per-edge normalizations, and
the loader that carries JAX-initialized parameters into the port.

The training-graph packs (``TrainingGraph``, ROADMAP A5), the block path
(``run_blocks``, A10) and the partitioned bundle (A12) come later.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ...core.graph import Graph
from ...device import DeviceLike

__all__ = ["GraphBundle", "edge_norms", "make_bundle", "from_jax_params"]


@dataclasses.dataclass(frozen=True, eq=False)
class GraphBundle:
    """Graph + precomputed per-edge normalization weights, both on the
    graph's device, in CALLER edge order.

    ``gcn_norm``: 1/sqrt(deg_out(u)·deg_in(v)); ``mean_norm``:
    1/deg_in(v) — mean aggregation as a weighted Copy-Reduce.
    """
    g: Graph
    gcn_norm: torch.Tensor   # (n_edges,)
    mean_norm: torch.Tensor  # (n_edges,)


def edge_norms(g: Graph) -> Tuple[np.ndarray, np.ndarray]:
    """Per-edge (gcn, mean) normalization weights in caller edge order,
    degrees clamped ≥ 1, computed on the host in float64 and stored as
    float32 — the same numbers as the JAX package's ``edge_norms``."""
    deg_in = np.maximum(g.host.in_degrees.astype(np.float64), 1)
    deg_out = np.maximum(g.host.out_degrees.astype(np.float64), 1)
    src, dst = g.host.src, g.host.dst
    w = 1.0 / np.sqrt(deg_out[src] * deg_in[dst])
    mean_w = 1.0 / deg_in[dst]
    w_caller = np.zeros_like(w)
    w_caller[g.host.eid] = w
    m_caller = np.zeros_like(mean_w)
    m_caller[g.host.eid] = mean_w
    return w_caller.astype(np.float32), m_caller.astype(np.float32)


def make_bundle(g: Graph) -> GraphBundle:
    """Assemble a bundle on ``g``'s device."""
    w_caller, m_caller = edge_norms(g)
    return GraphBundle(g=g,
                       gcn_norm=torch.from_numpy(w_caller).to(g.device),
                       mean_norm=torch.from_numpy(m_caller).to(g.device))


def from_jax_params(app: str, tree, device: DeviceLike = "cuda") -> nn.Module:
    """The port's model for ``app`` ('gcn' | 'sage' | 'gat') holding the
    JAX params pytree ``tree`` (leaves as numpy arrays), computing the
    same function as the JAX model with those params."""
    from . import gat, gcn, sage

    mods = {"gcn": gcn.GCN, "sage": sage.SAGE, "gat": gat.GAT}
    if app not in mods:
        raise ValueError(f"unknown app {app!r}; expected one of "
                         f"{tuple(mods)}")
    return mods[app].from_numpy(tree, device)
