"""Reduce-stage strategies (port of ``repro/core/strategies.py``).

This slice ports the plain one: ``pull_segment``, a destination-sorted
segment reduction (paper Alg. 2), for every reducer of the lattice (sum,
mean, max, min, prod). It is the reference every CUDA kernel of the port
is held against. A sum walks the sorted stream with one owner per output
row (``torch.segment_reduce``), so it is bit-identical from call to call
on the card too, where an ``index_add_`` adds by atomics in whatever
order the threads arrive. The push, blocked-ELL and one-hot strategies
are queued as ROADMAP item A3.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["REDUCE_IDENTITY", "finalize_empty_rows", "pull_segment"]

REDUCE_IDENTITY = {
    "sum": 0.0,
    "mean": 0.0,
    "max": -float("inf"),
    "min": float("inf"),
    "prod": 1.0,
}

# torch.scatter_reduce's name for each reducer that is not a sum
_SCATTER = {"max": "amax", "min": "amin", "prod": "prod"}


def finalize_empty_rows(out: torch.Tensor, deg: torch.Tensor,
                        reduce_op: str) -> torch.Tensor:
    """DGL semantics: rows with no incoming edge are 0, for every ⊕."""
    if reduce_op == "sum":
        return out  # a segment sum already yields 0 for empty rows
    has = (deg > 0).reshape(deg.shape + (1,) * (out.ndim - 1))
    return torch.where(has, out, torch.zeros((), dtype=out.dtype,
                                             device=out.device))


def pull_segment(msg: torch.Tensor, tgt_sorted: torch.Tensor, n_tgt: int,
                 reduce_op: str, deg: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """Segment reduction of per-edge messages ``msg`` (E, *feat) onto
    ``n_tgt`` rows; ``tgt_sorted`` is the int64 target of each edge, in
    non-decreasing order, and ``deg`` (when given) the number of edges of
    each target row — the segment lengths of a sum or mean.

    As in the JAX package, an extremum that is not finite (an empty row's
    identity, or an infinite message) becomes 0, and with ``deg`` given
    every empty row is 0 — a product's included.
    """
    shape = (n_tgt,) + tuple(msg.shape[1:])
    if reduce_op in ("sum", "mean"):
        lengths = (torch.bincount(tgt_sorted, minlength=n_tgt)
                   if deg is None else deg.long())
        # the lengths are a graph's degrees, right by construction:
        # ``unsafe`` skips the checks that read them back to the host
        out = torch.segment_reduce(msg, "sum", lengths=lengths, unsafe=True)
        if reduce_op == "mean":
            d = deg.clamp(min=1).to(msg.dtype)
            out = out / d.reshape((n_tgt,) + (1,) * (msg.ndim - 1))
    elif reduce_op in _SCATTER:
        # identity-filled output with include_self: an empty row keeps the
        # identity, exactly what jax.ops.segment_{max,min,prod} return
        out = torch.full(shape, REDUCE_IDENTITY[reduce_op], dtype=msg.dtype,
                         device=msg.device)
        idx = tgt_sorted.reshape((-1,) + (1,) * (msg.ndim - 1)).expand_as(msg)
        out = out.scatter_reduce(0, idx, msg, _SCATTER[reduce_op],
                                 include_self=True)
        if reduce_op != "prod":
            out = torch.where(torch.isfinite(out), out,
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device))
    else:
        raise ValueError(f"unknown reduce op {reduce_op!r}")
    return finalize_empty_rows(out, deg, reduce_op) if deg is not None else out
