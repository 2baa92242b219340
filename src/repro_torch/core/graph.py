"""Graph container for the aggregation primitives (port of
``repro/core/graph.py``).

``Graph`` sorts the edge list canonically by ``(dst, src)`` once, at
construction, exactly as the JAX package does, and exposes

  * COO views ``(src, dst, eid)`` sorted by destination (pull order),
  * CSR-by-destination ``indptr_dst`` — the layout both CUDA kernels walk,
  * CSC-by-source ``indptr_src`` + ``perm_src`` (push order),
  * ``eid`` / ``eid_inv`` between canonical slots and caller edge ids,
  * ``src_caller`` / ``dst_caller``, each edge's endpoints in caller edge
    order (``src[eid_inv]``, ``dst[eid_inv]``; made on first use), the
    arrays the JAX ``gather`` plan computes as ``src_c`` / ``dst_c``.

:func:`reverse` gives the graph with every edge reversed (Gᵀ), keeping
the caller's edge ids, so one caller-order edge operand lines up on G
and on Gᵀ; the backward passes pull over it. :func:`reverse_from_draw`
builds the same Gᵀ of a sampled block from the sampler's draw.

Every index array lives twice: as host numpy (``g.host``) and as an
int32 tensor on ``g.device``, the dtype the kernels take. The plain
PyTorch versions index with int64 copies made on first use
(:meth:`Graph.long`).
"""
from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..obs.spans import span

__all__ = ["Graph", "HostIndex", "from_coo", "reverse", "reverse_from_draw",
           "reverse_built", "add_self_loops"]

_INDEX_FIELDS = ("src", "dst", "eid", "indptr_dst", "indptr_src",
                 "perm_src", "eid_inv")


@dataclasses.dataclass(frozen=True)
class HostIndex:
    """Host (numpy int32) copies of every index array of a graph."""
    src: np.ndarray
    dst: np.ndarray
    eid: np.ndarray
    indptr_dst: np.ndarray
    indptr_src: np.ndarray
    perm_src: np.ndarray
    eid_inv: np.ndarray

    @property
    def in_degrees(self) -> np.ndarray:
        return np.diff(self.indptr_dst)

    @property
    def out_degrees(self) -> np.ndarray:
        return np.diff(self.indptr_src)


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash
class Graph:
    """Directed graph with dual CSR/CSC index structure on one device."""

    src: torch.Tensor         # (nnz,) int32, canonical (dst, src) order
    dst: torch.Tensor         # (nnz,) int32, non-decreasing
    eid: torch.Tensor         # (nnz,) canonical slot -> caller edge id
    indptr_dst: torch.Tensor  # (n_dst + 1,) CSR by destination
    indptr_src: torch.Tensor  # (n_src + 1,) CSC by source
    perm_src: torch.Tensor    # (nnz,) sorted-by-src -> canonical slot
    eid_inv: torch.Tensor     # (nnz,) caller edge id -> canonical slot
    n_src: int
    n_dst: int
    n_edges: int
    host: HostIndex
    _long: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)
    _derived: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def in_degrees(self) -> torch.Tensor:
        """(n_dst,) int32 number of incoming edges per destination."""
        return self.indptr_dst[1:] - self.indptr_dst[:-1]

    @property
    def out_degrees(self) -> torch.Tensor:
        """(n_src,) int32 number of outgoing edges per source."""
        return self.indptr_src[1:] - self.indptr_src[:-1]

    @property
    def src_caller(self) -> torch.Tensor:
        """(nnz,) int32 source of each edge in caller edge order."""
        return self._caller("src")

    @property
    def dst_caller(self) -> torch.Tensor:
        """(nnz,) int32 destination of each edge in caller edge order."""
        return self._caller("dst")

    def _caller(self, name: str) -> torch.Tensor:
        key = f"{name}_caller"
        t = self._derived.get(key)
        if t is None:
            t = getattr(self, name).index_select(
                0, self.eid_inv.long()).contiguous()
            self._derived[key] = t
        return t

    def long(self, name: str) -> torch.Tensor:
        """int64 copy of index array ``name`` on the graph's device, made
        once — the plain versions' index type."""
        t = self._long.get(name)
        if t is None:
            t = getattr(self, name).long()
            self._long[name] = t
        return t

    def to(self, device: DeviceLike) -> "Graph":
        """The same graph with its tensors on ``device``."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        return _from_host(self.host, self.n_src, self.n_dst, dev)

    def __repr__(self):
        return (f"Graph(n_src={self.n_src}, n_dst={self.n_dst}, "
                f"n_edges={self.n_edges}, device={self.device})")


def _from_host(host: HostIndex, n_src: int, n_dst: int,
               dev: torch.device) -> Graph:
    n_edges = int(host.src.shape[0])
    with span("graph.upload", args={"n_edges": n_edges}):
        tensors = {f: torch.from_numpy(getattr(host, f)).to(dev)
                   for f in _INDEX_FIELDS}
    return Graph(n_src=n_src, n_dst=n_dst, n_edges=n_edges, host=host,
                 **tensors)


def from_coo(src, dst, *, n_src: Optional[int] = None,
             n_dst: Optional[int] = None,
             device: DeviceLike = "cuda") -> Graph:
    """Build a :class:`Graph` from host COO edge arrays.

    Edge ids are assigned in the caller's order: edge features passed to
    the aggregation primitives are indexed in the order of ``src``/``dst``
    given here. The sort and every derived index are computed on the
    host, identically to ``repro.core.graph.from_coo``.
    """
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src/dst must be equal-length 1-D, got "
                         f"{src.shape} vs {dst.shape}")
    nnz = src.shape[0]
    n_src = int(n_src if n_src is not None else (src.max() + 1 if nnz else 0))
    n_dst = int(n_dst if n_dst is not None else (dst.max() + 1 if nnz else 0))
    if nnz and (src.min() < 0 or src.max() >= n_src):
        raise ValueError("src ids out of range")
    if nnz and (dst.min() < 0 or dst.max() >= n_dst):
        raise ValueError("dst ids out of range")
    if max(nnz, n_src, n_dst) >= 2 ** 31:
        raise ValueError("graph too large for int32 indices")
    return _from_host(_host_index(src, dst, n_src, n_dst), n_src, n_dst, dev)


def _host_index(src: np.ndarray, dst: np.ndarray, n_src: int,
                n_dst: int) -> HostIndex:
    """Every index array of the graph with int64 host edges ``src`` /
    ``dst``, edge ids by position, as ``repro.core.graph.from_coo``
    computes them (span ``graph.host_index``)."""
    nnz = src.shape[0]
    with span("graph.host_index", args={"n_edges": int(nnz)}):
        order = np.lexsort((src, dst))
        s_src, s_dst = src[order], dst[order]
        eid = order.astype(np.int32)

        indptr_dst = np.zeros(n_dst + 1, dtype=np.int32)
        np.add.at(indptr_dst, s_dst + 1, 1)
        np.cumsum(indptr_dst, out=indptr_dst)

        order_src = np.lexsort((s_dst, s_src))
        indptr_src = np.zeros(n_src + 1, dtype=np.int32)
        np.add.at(indptr_src, s_src + 1, 1)
        np.cumsum(indptr_src, out=indptr_src)

        eid_inv = np.empty_like(eid)
        eid_inv[eid] = np.arange(nnz, dtype=np.int32)

        return HostIndex(
            src=s_src.astype(np.int32), dst=s_dst.astype(np.int32), eid=eid,
            indptr_dst=indptr_dst, indptr_src=indptr_src,
            perm_src=order_src.astype(np.int32), eid_inv=eid_inv)


_reverse_lock = threading.Lock()
_reversed: "weakref.WeakKeyDictionary[Graph, Graph]" = (
    weakref.WeakKeyDictionary())


def reverse(g: Graph) -> Graph:
    """Gᵀ: every edge of ``g`` reversed, on ``g``'s device, keeping the
    caller's edge ids (``eid`` / ``eid_inv`` remapped as
    ``repro.core.graph.reverse`` remaps them), so an edge operand in
    caller order lines up on both graphs. Built from ``g.host`` at first
    use and kept for as long as ``g`` lives, so a training run builds Gᵀ,
    and the kernels' per-graph structures on it, once."""
    rg = _reversed.get(g)      # lock-free hit: every backward asks
    if rg is not None:
        return rg
    with _reverse_lock:
        rg = _reversed.get(g)
        if rg is None:
            h = g.host
            rh = _host_index(h.dst.astype(np.int64), h.src.astype(np.int64),
                             g.n_dst, g.n_src)
            # from the positions of g's canonical slots to caller ids
            eid = h.eid[rh.eid]
            eid_inv = np.empty_like(eid)
            eid_inv[eid] = np.arange(eid.shape[0], dtype=eid.dtype)
            rh = dataclasses.replace(rh, eid=eid, eid_inv=eid_inv)
            rg = _from_host(rh, g.n_dst, g.n_src, g.device)
            _reversed[g] = rg
        return rg


def reverse_from_draw(g: Graph, src: np.ndarray, dst: np.ndarray) -> Graph:
    """Gᵀ of ``g`` from its caller-order host edges ``src`` / ``dst``
    when ``dst`` is non-decreasing, as a sampler's draw emits a block's
    edges (real edges row by row, pad edges last, in the dummy row).
    Then one stable sort by source is Gᵀ's canonical order — the JAX
    sampler's reverse table ``rev_eid`` — and every other index follows
    from it and ``g.host`` with no further sort. Bit-equal to
    :func:`reverse`; kept as ``g``'s Gᵀ (what :func:`reverse` returns
    from now on) and returned."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    if src.shape != (g.n_edges,) or dst.shape != (g.n_edges,):
        raise ValueError("src/dst must hold one entry per edge of g")
    if g.n_edges and (np.diff(dst) < 0).any():
        raise ValueError("reverse_from_draw needs dst in non-decreasing "
                         "order; use reverse(g)")
    h = g.host
    eid = np.argsort(src, kind="stable").astype(np.int32)
    eid_inv = np.empty_like(eid)
    eid_inv[eid] = np.arange(eid.shape[0], dtype=np.int32)
    indptr_dst = np.zeros(g.n_src + 1, np.int32)
    np.cumsum(np.bincount(src, minlength=g.n_src), out=indptr_dst[1:])
    rh = HostIndex(src=dst[eid].astype(np.int32),
                   dst=src[eid].astype(np.int32), eid=eid,
                   indptr_dst=indptr_dst, indptr_src=h.indptr_dst,
                   # G's canonical order is Gᵀ's sorted by its source
                   perm_src=eid_inv[h.eid], eid_inv=eid_inv)
    rg = _from_host(rh, g.n_dst, g.n_src, g.device)
    with _reverse_lock:
        _reversed[g] = rg
    return rg


def reverse_built(g: Graph) -> bool:
    """Has ``g``'s Gᵀ been built (or set) already?"""
    return _reversed.get(g) is not None


def add_self_loops(src, dst, n: int):
    """Append one self-loop per node to host COO arrays (GCN-style)."""
    src = np.concatenate([np.asarray(src, np.int64), np.arange(n)])
    dst = np.concatenate([np.asarray(dst, np.int64), np.arange(n)])
    return src, dst
