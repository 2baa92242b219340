"""Reduce-stage strategies (port of ``repro/core/strategies.py``).

This slice ports the plain one: ``pull_segment``, a destination-sorted
segment reduction (paper Alg. 2), for the sum and mean reducers. It is
the reference every CUDA kernel of the port is held against. The push,
blocked-ELL and one-hot strategies and the max/min/prod reducers are
queued as ROADMAP item A3.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["finalize_empty_rows", "pull_segment"]


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
    ``n_tgt`` rows; ``tgt_sorted`` is the int64 target of each edge."""
    if reduce_op not in ("sum", "mean"):
        raise NotImplementedError(
            f"reducer {reduce_op!r} is not ported yet (ROADMAP A3); this "
            f"slice supports sum and mean")
    out = torch.zeros((n_tgt,) + tuple(msg.shape[1:]), dtype=msg.dtype,
                      device=msg.device)
    out.index_add_(0, tgt_sorted, msg)
    if reduce_op == "mean":
        d = deg.clamp(min=1).to(msg.dtype)
        out = out / d.reshape((n_tgt,) + (1,) * (msg.ndim - 1))
    return finalize_empty_rows(out, deg, reduce_op) if deg is not None else out
