"""Training-grade aggregation: the weighted pull in both directions (port
of ``repro/core/training_ops.py``).

Autodiff of a gather-based pull gives a scatter-add backward. But the
adjoint of Copy-Reduce is Copy-Reduce on the REVERSE graph (the paper's
observation for Embedding), so :func:`weighted_copy_reduce` pulls in both
directions:

  forward:   out[v] = Σ_{e=(u→v)} w_e · x[u]       pull on G
  ∂x:        dx[u]  = Σ_{e=(u→v)} w_e · ct[v]      pull on Gᵀ
  ∂w:        dw[e]  = ⟨x[u_e], ct[v_e]⟩            per-edge dot

each computed only when autograd asks for it, by one of two routes:

* ``"kernel"`` (and ``"auto"``) — ``gspmm``'s kernel route: B1 weighted
  sum on G forward, on Gᵀ for ∂x, B3 ``u_dot_v`` for ∂w
  (``core/binary_reduce.py``, "Gradients"). On the CPU the wrappers run
  their plain versions.
* ``"ell"`` — the JAX package's route: the blocked pull over the
  degree-bucketed ELL packs of G and Gᵀ (:class:`TrainingGraph` ``ell`` /
  ``ell_rev``), with its custom VJP as :class:`_EllPull`. Plain PyTorch:
  ELL is a TPU layout.
"""
from __future__ import annotations

import dataclasses

import torch

from . import strategies as S
from .binary_reduce import gspmm
from .graph import Graph, reverse
from .planner import get_plan_cache
from .tiling import ELLPack

__all__ = ["TrainingGraph", "make_training_graph", "weighted_copy_reduce",
           "TRAINING_STRATEGIES"]

TRAINING_STRATEGIES = ("auto", "kernel", "ell")


@dataclasses.dataclass(frozen=True, eq=False)
class TrainingGraph:
    """A graph, its reverse (Gᵀ keeps the caller's edge ids) and the
    blocked ELL pack of each."""
    g: Graph
    g_rev: Graph
    ell: ELLPack
    ell_rev: ELLPack


def make_training_graph(g: Graph, width_cap: int = 64) -> TrainingGraph:
    """Gᵀ comes from :func:`~repro_torch.core.graph.reverse`, built once
    per graph and shared with the kernel routes' backwards; the packs
    from each graph's :class:`~repro_torch.core.planner.PlanCache`, so the
    forward pack is the one ``gspmm(strategy="ell")`` uses, built at most
    once."""
    g_rev = reverse(g)
    return TrainingGraph(g=g, g_rev=g_rev,
                         ell=get_plan_cache(g).ell(width_cap),
                         ell_rev=get_plan_cache(g_rev).ell(width_cap))


def _pull_weighted(g: Graph, pack: ELLPack, x: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Blocked-pull Σ w_e·x[src_e] into destinations; ``w`` (n_edges, 1)
    in caller edge order. The feature dtype comes back."""
    def msg_fn(cls):
        cols, eids = cls.long("chunk_cols"), cls.long("chunk_eids")
        vals = x.index_select(0, cols.reshape(-1)).reshape(
            tuple(cols.shape) + tuple(x.shape[1:]))           # (C, W, d)
        ws = w.index_select(0, eids.reshape(-1)).reshape(
            tuple(eids.shape) + tuple(w.shape[1:]))           # (C, W, 1)
        return vals * ws

    out = S.pull_ell_reduce(pack, msg_fn, "sum", deg=g.in_degrees)
    if (x.dtype.is_floating_point and out.dtype.is_floating_point
            and out.dtype != x.dtype):
        out = out.to(x.dtype)
    return out


class _EllPull(torch.autograd.Function):
    """The blocked pull with the JAX custom VJP
    (``repro/core/training_ops.py:81-103``): ∂x the pull over Gᵀ's pack,
    ∂w the per-edge dot in caller order."""

    @staticmethod
    def forward(ctx, tg, x, w):
        ctx.tg = tg
        ctx.save_for_backward(x, w)
        return _pull_weighted(tg.g, tg.ell, x, w)

    @staticmethod
    def backward(ctx, ct):
        x, w = ctx.saved_tensors
        tg = ctx.tg
        need_x, need_w = ctx.needs_input_grad[1:]
        dx = dw = None
        if need_x:      # Gᵀ keeps the caller's edge ids: w lines up
            dx = _pull_weighted(tg.g_rev, tg.ell_rev, ct, w).to(x.dtype)
        if need_w:
            src, dst = tg.g.long("src"), tg.g.long("dst")
            dot = (x.index_select(0, src) * ct.index_select(0, dst)).sum(
                -1, keepdim=True)
            dw = dot.index_select(0, tg.g.long("eid_inv")).to(w.dtype)
        return None, dx, dw


def weighted_copy_reduce(tg: TrainingGraph, x: torch.Tensor,
                         w: torch.Tensor,
                         strategy: str = "auto") -> torch.Tensor:
    """out[v] = Σ_{(u→v)=e} w[e]·x[u], pulled forward and backward.

    ``x``: (n_src, d); ``w``: (n_edges, 1) in caller edge order (pass
    ones for a plain sum). ``strategy``: 'auto' / 'kernel' (B1, the
    route on the card) or 'ell' (the blocked pull over ``tg``'s packs).
    """
    if strategy not in TRAINING_STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; expected one of "
                         f"{TRAINING_STRATEGIES}")
    if strategy == "ell":
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            return _EllPull.apply(tg, x, w)
        return _pull_weighted(tg.g, tg.ell, x, w)
    return gspmm(tg.g, "u_mul_e_add_v", u=x, e=w, strategy="kernel")
