"""Training-grade aggregation: the weighted pull in both directions (port
of ``repro/core/training_ops.py``).

Autodiff of a gather-based pull gives a scatter-add backward. But the
adjoint of Copy-Reduce is Copy-Reduce on the REVERSE graph (the paper's
observation for Embedding). In the port that is what the kernel route of
``gspmm`` already does (``core/binary_reduce.py``, "Gradients"), so
:func:`weighted_copy_reduce` is that route under the JAX package's name:

  forward:   out[v] = Σ_{e=(u→v)} w_e · x[u]       B1 weighted sum on G
  ∂x:        dx[u]  = Σ_{e=(u→v)} w_e · ct[v]      B1 weighted sum on Gᵀ
  ∂w:        dw[e]  = ⟨x[u_e], ct[v_e]⟩            B3 ``u_dot_v`` (x, ct)

each computed only when autograd asks for it. On the CPU the wrappers run
their plain versions. The JAX package's degree-bucketed ELL packs are a
TPU layout: B1 walks the CSR of G and of Gᵀ directly, so
:class:`TrainingGraph` carries the two graphs only.
"""
from __future__ import annotations

import dataclasses

import torch

from .binary_reduce import gspmm
from .graph import Graph, reverse

__all__ = ["TrainingGraph", "make_training_graph", "weighted_copy_reduce"]


@dataclasses.dataclass(frozen=True, eq=False)
class TrainingGraph:
    """A graph and its reverse (Gᵀ keeps the caller's edge ids)."""
    g: Graph
    g_rev: Graph


def make_training_graph(g: Graph) -> TrainingGraph:
    """Gᵀ comes from :func:`~repro_torch.core.graph.reverse`, built once
    per graph and shared with the kernel routes' backwards."""
    return TrainingGraph(g=g, g_rev=reverse(g))


def weighted_copy_reduce(tg: TrainingGraph, x: torch.Tensor,
                         w: torch.Tensor) -> torch.Tensor:
    """out[v] = Σ_{(u→v)=e} w[e]·x[u] — B1 forward AND backward.

    ``x``: (n_src, d) fp32; ``w``: (n_edges, 1) in caller edge order
    (pass ones for a plain sum).
    """
    return gspmm(tg.g, "u_mul_e_add_v", u=x, e=w, strategy="kernel")
