"""Row-segment work list: destination rows cut into bounded edge segments.

A power-law graph's heaviest destination row holds thousands of edges
(in-degree 4,275 on ``reddit-like``). A kernel that gives each row to
one warp waits on that warp's serial loop. The work list cuts every row
of the CSR by destination into segments of at most ``K`` edges, so a
kernel can give each segment its own warp:

* a row of in-degree ≤ K (an empty row too) is one segment, which
  writes the row's output directly;
* a heavier row becomes ⌈deg/K⌉ consecutive segments, in edge order.
  Segment ``i`` of such a row writes partial slot ``first + i`` of a
  workspace, and a combine pass folds the row's slots **in slot order**
  (so in edge order), never in arrival order. Results are therefore
  bit-identical from call to call.

The list is kernel-agnostic (B1 and B2 take it at K = 256, B4 and B5 at
K = 128), built once per (graph, K) in plain torch on the graph's device
and cached on the graph object weakly: :func:`row_split` builds nothing
on a repeated call.
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Dict

import torch

__all__ = ["SEGMENT_EDGES", "RowSplit", "row_split", "build_row_split"]

# K of the list that B1 and B2 launch on; spmm_csr.cu's header says why
SEGMENT_EDGES = 256


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """The segments of one graph's rows at cap ``K``.

    ``seg`` (n_segments, 4) int32 rows ``(row, first edge, end edge,
    slot)``: the segment covers canonical edges ``[first, end)`` of
    destination ``row``; ``slot`` is its partial slot, or -1 when the
    segment is the whole row. Segments are listed longest first (stable,
    so equal lengths keep row and edge order): a grid walks the heavy
    segments first and the short tail last.

    ``split`` (n_split, 3) int32 rows ``(row, first slot, count)``, one
    per row of in-degree > K, in row order; the row's segments own slots
    ``first … first + count - 1`` in edge order.
    """
    K: int
    seg: torch.Tensor
    split: torch.Tensor
    n_segments: int
    n_split: int
    n_partials: int
    max_segment: int


def build_row_split(indptr_dst: torch.Tensor, K: int) -> RowSplit:
    """Build the work list of CSR ``indptr_dst`` at cap ``K`` on the
    tensor's device (uncached; callers use :func:`row_split`)."""
    if K < 1:
        raise ValueError(f"segment cap K must be >= 1, got {K}")
    dev = indptr_dst.device
    ip = indptr_dst.long()
    n_dst = ip.numel() - 1
    deg = ip[1:] - ip[:-1]
    nseg = torch.clamp((deg + K - 1) // K, min=1)
    rows = torch.arange(n_dst, device=dev)
    seg_row = torch.repeat_interleave(rows, nseg)
    seg0 = torch.cumsum(nseg, 0) - nseg          # first segment of a row
    i = torch.arange(seg_row.numel(), device=dev) - seg0[seg_row]
    beg = ip[seg_row] + i * K
    end = torch.minimum(beg + K, ip[seg_row + 1])
    is_split = nseg > 1
    split_rows = rows[is_split]
    count = nseg[is_split]
    first = torch.cumsum(count, 0) - count
    first_of_row = torch.full((n_dst,), -1, dtype=torch.long, device=dev)
    first_of_row[split_rows] = first
    slot = torch.where(is_split[seg_row], first_of_row[seg_row] + i,
                       torch.full_like(i, -1))
    order = torch.argsort(end - beg, descending=True, stable=True)
    seg = torch.stack([seg_row, beg, end, slot], 1)[order]
    seg = seg.to(torch.int32).contiguous()
    split = torch.stack([split_rows, first, count], 1).to(
        torch.int32).contiguous()
    return RowSplit(K=int(K), seg=seg, split=split,
                    n_segments=int(seg.shape[0]),
                    n_split=int(split.shape[0]),
                    n_partials=int(count.sum()),
                    max_segment=int(deg.clamp(max=K).max()) if n_dst else 0)


_lock = threading.Lock()
_cache: "weakref.WeakKeyDictionary[object, Dict[int, RowSplit]]" = (
    weakref.WeakKeyDictionary())


def row_split(g, K: int = SEGMENT_EDGES) -> RowSplit:
    """The work list of graph ``g`` at cap ``K``, built on ``g.device`` at
    first use and kept for as long as ``g`` lives."""
    per_graph = _cache.get(g)    # lock-free hit: the wrapper's hot path
    rs = None if per_graph is None else per_graph.get(K)
    if rs is not None:
        return rs
    with _lock:
        per_graph = _cache.setdefault(g, {})
        rs = per_graph.get(K)
        if rs is None:
            rs = build_row_split(g.indptr_dst, K)
            per_graph[K] = rs
        return rs
