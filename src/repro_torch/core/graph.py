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

Every index array lives twice: as host numpy (``g.host``) and as an
int32 tensor on ``g.device``, the dtype the kernels take. The plain
PyTorch versions index with int64 copies made on first use
(:meth:`Graph.long`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["Graph", "HostIndex", "from_coo", "add_self_loops"]

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
    tensors = {f: torch.from_numpy(getattr(host, f)).to(dev)
               for f in _INDEX_FIELDS}
    return Graph(n_src=n_src, n_dst=n_dst, n_edges=int(host.src.shape[0]),
                 host=host, **tensors)


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

    host = HostIndex(src=s_src.astype(np.int32), dst=s_dst.astype(np.int32),
                     eid=eid, indptr_dst=indptr_dst, indptr_src=indptr_src,
                     perm_src=order_src.astype(np.int32), eid_inv=eid_inv)
    return _from_host(host, n_src, n_dst, dev)


def add_self_loops(src, dst, n: int):
    """Append one self-loop per node to host COO arrays (GCN-style)."""
    src = np.concatenate([np.asarray(src, np.int64), np.arange(n)])
    dst = np.concatenate([np.asarray(dst, np.int64), np.arange(n)])
    return src, dst
