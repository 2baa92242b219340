"""Blocked edge formats (port of ``repro/core/tiling.py``): the paper's
Alg. 3 blocking, as preprocessing.

Two packed formats, built on the host in numpy from a graph's
:class:`~repro_torch.core.graph.HostIndex` and uploaded once to the
graph's device:

* :class:`ELLPack` — degree-bucketed padded ELL: rows grouped by
  power-of-two in-degree class, each class a dense ``(chunks, width)``
  table; rows wider than ``width_cap`` split into cap-wide chunks that a
  second-stage segment reduce combines (``strategies.pull_ell_reduce``).
  :func:`build_ell_ragged` is the row-complete variant (no split) and
  :func:`build_ell_uniform` one class padded to a fixed width.
* :class:`TilePack` — edges bucketed by ``(dst-tile, src-tile)`` pair,
  sorted within buckets and cut into ``eb``-edge buckets, the layout of
  ``strategies.onehot_spmm``.

Every array equals the JAX package's (same chunk order, pad slots, masks,
``chunk_eids``, ``tile_m`` / ``tile_k``): the builders compute JAX's
Python loops as vectorized numpy. Index arrays are int32 on the device,
as the graph's are; :meth:`ELLClass.long` / :meth:`TilePack.long` give
the int64 copies the plain routes index with, made once. These are TPU
layouts: the CUDA kernels walk the CSR instead, so every route over a
pack is plain PyTorch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["ELLClass", "ELLPack", "TilePack", "build_ell", "build_ell_ragged",
           "build_ell_uniform", "build_tiles"]


class _Long:
    """int64 copies of a pack's int32 index tensors, made once each."""

    def long(self, name: str) -> torch.Tensor:
        t = self._long.get(name)
        if t is None:
            t = self._long[name] = getattr(self, name).long()
        return t


@dataclasses.dataclass(frozen=True, eq=False)
class ELLClass(_Long):
    """One degree class of the bucketed ELL: all chunks of width ``width``."""
    chunk_cols: torch.Tensor   # (n_chunks, width) int32 source ids (0 pad)
    chunk_eids: torch.Tensor   # (n_chunks, width) int32 edge ids   (0 pad)
    chunk_mask: torch.Tensor   # (n_chunks, width) bool
    chunk_row: torch.Tensor    # (n_chunks,) int32 destination row
    width: int
    _long: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    def row_lengths(self, n_dst: int) -> torch.Tensor:
        """(n_dst,) int64 chunks per destination row: the segment lengths
        of the class's sorted second-stage reduce, made once."""
        key = ("row_lengths", n_dst)
        t = self._long.get(key)
        if t is None:
            t = self._long[key] = torch.bincount(self.long("chunk_row"),
                                                 minlength=n_dst)
        return t


@dataclasses.dataclass(frozen=True, eq=False)
class ELLPack:
    """Degree-bucketed padded ELL: a tuple of per-width classes."""
    classes: Tuple[ELLClass, ...]
    n_dst: int

    @property
    def slots(self) -> int:
        """Padded (chunk, slot) cells over every class."""
        return sum(int(c.chunk_mask.shape[0]) * c.width for c in self.classes)


@dataclasses.dataclass(frozen=True, eq=False)
class TilePack(_Long):
    """(M-tile, K-tile)-bucketed edge lists, sorted by (mi, ki, dst, src).

    Buckets hold ``eb`` edge slots; a (mi, ki) pair with more than ``eb``
    edges is split into consecutive buckets with the same tile coordinates.
    ``first_of_m[t]`` is 1 iff bucket ``t`` is the first of its M-tile.
    """
    tile_m: torch.Tensor       # (T,) int32 M-tile index per bucket
    tile_k: torch.Tensor       # (T,) int32 K-tile index per bucket
    first_of_m: torch.Tensor   # (T,) int32 1/0 flag
    dst_local: torch.Tensor    # (T, eb) int32 dst offset inside the M-tile
    src_local: torch.Tensor    # (T, eb) int32 src offset inside the K-tile
    eids: torch.Tensor         # (T, eb) int32 caller edge ids (0 pad)
    mask: torch.Tensor         # (T, eb) bool
    bm: int
    bk: int
    eb: int
    n_dst: int
    n_src: int
    n_tiles_m: int
    n_tiles_k: int
    _long: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def n_buckets(self) -> int:
        return int(self.tile_m.shape[0])

    def m_lengths(self) -> torch.Tensor:
        """(n_tiles_m,) int64 buckets per M-tile: the segment lengths of
        the one-hot route's sorted combine, made once."""
        t = self._long.get("m_lengths")
        if t is None:
            t = self._long["m_lengths"] = torch.bincount(
                self.long("tile_m"), minlength=self.n_tiles_m)
        return t


def _pow2_width(ln: np.ndarray) -> np.ndarray:
    """Next power of two ≥ each length (1 for lengths 0 and 1), computed
    as the JAX builders compute it."""
    ln = np.asarray(ln, np.int64)
    w = np.ones_like(ln)
    big = ln > 1
    w[big] = np.left_shift(1, np.ceil(np.log2(ln[big])).astype(np.int64))
    return w


def _fill(src: np.ndarray, eid: np.ndarray, starts: np.ndarray,
          lens: np.ndarray, width: int):
    """(cols, eids, mask) of chunks reading ``lens[k]`` edges from
    ``starts[k]`` of the canonical stream, padded with 0 to ``width``."""
    mask = np.arange(width)[None, :] < lens[:, None]
    if src.size == 0:
        z = np.zeros(mask.shape, np.int32)
        return z, z.copy(), mask
    idx = np.minimum(starts[:, None] + np.arange(width)[None, :],
                     src.size - 1)
    cols = np.where(mask, src[idx], 0).astype(np.int32)
    eids = np.where(mask, eid[idx], 0).astype(np.int32)
    return cols, eids, mask


def _ell_from_chunks(g, rows, starts, lens, device) -> ELLPack:
    """Group chunks ``(row, start, len)`` — given in (row, start) order —
    into width classes sorted by (width, row), as the JAX builders'
    stable sort does; one dummy empty chunk when there is none."""
    h = g.host
    src = h.src.astype(np.int64)
    eid = h.eid.astype(np.int64)
    if rows.size == 0:
        rows = np.zeros(1, np.int64)
        starts = np.zeros(1, np.int64)
        lens = np.zeros(1, np.int64)
    widths = _pow2_width(lens)
    order = np.lexsort((rows, widths))          # stable: keeps start order
    rows, starts, lens, widths = (a[order] for a in (rows, starts, lens,
                                                     widths))
    classes = []
    for w in np.unique(widths):
        sel = widths == w
        cols, eids, mask = _fill(src, eid, starts[sel], lens[sel], int(w))
        classes.append(ELLClass(
            chunk_cols=torch.from_numpy(cols).to(device),
            chunk_eids=torch.from_numpy(eids).to(device),
            chunk_mask=torch.from_numpy(mask).to(device),
            chunk_row=torch.from_numpy(rows[sel].astype(np.int32)).to(device),
            width=int(w)))
    return ELLPack(classes=tuple(classes), n_dst=g.n_dst)


def _chunks(indptr: np.ndarray, cap: Optional[int]):
    """``(row, start, len)`` of every chunk, in (row, start) order: each
    non-empty row cut into ``cap``-wide chunks (whole when ``cap`` is
    None)."""
    indptr = indptr.astype(np.int64)
    deg = indptr[1:] - indptr[:-1]
    nz = np.nonzero(deg)[0]
    if cap is None:
        return nz, indptr[nz], deg[nz]
    n_ch = -(-deg[nz] // cap)
    rows = np.repeat(nz, n_ch)
    k = np.arange(rows.size) - np.repeat(np.cumsum(n_ch) - n_ch, n_ch)
    starts = indptr[rows] + k * cap
    lens = np.minimum(cap, indptr[rows + 1] - starts)
    return rows, starts, lens


def build_ell(g, width_cap: int = 64) -> ELLPack:
    """Pack ``g`` into degree-bucketed padded ELL (``repro.core.tiling.
    build_ell``): chunks of at most ``width_cap`` edges, grouped by
    power-of-two width, each class's chunks ordered by row."""
    rows, starts, lens = _chunks(g.host.indptr_dst, int(width_cap))
    return _ell_from_chunks(g, rows, starts, lens, g.device)


def build_ell_ragged(g) -> ELLPack:
    """Row-complete ragged ELL: one chunk per non-empty row, in the class
    of the next power of two ≥ its in-degree (no split), so each class
    holds whole rows and rows are disjoint across classes."""
    rows, starts, lens = _chunks(g.host.indptr_dst, None)
    return _ell_from_chunks(g, rows, starts, lens, g.device)


def build_ell_uniform(g, width: int) -> ELLClass:
    """One class, one full row per chunk, padded to ``width`` (which must
    be ≥ the max in-degree)."""
    h = g.host
    indptr = h.indptr_dst.astype(np.int64)
    deg = indptr[1:] - indptr[:-1]
    if deg.size and deg.max() > width:
        raise ValueError(f"width {width} < max degree {deg.max()}")
    nz = np.nonzero(deg)[0]
    cols, eids, mask = _fill(h.src.astype(np.int64), h.eid.astype(np.int64),
                             indptr[nz], deg[nz], int(width))
    rows = nz.astype(np.int32)
    if nz.size == 0:             # one empty chunk, as in JAX
        cols, eids = (np.zeros((1, width), np.int32) for _ in range(2))
        mask = np.zeros((1, width), bool)
        rows = np.zeros(1, np.int32)
    dev = g.device
    return ELLClass(chunk_cols=torch.from_numpy(cols).to(dev),
                    chunk_eids=torch.from_numpy(eids).to(dev),
                    chunk_mask=torch.from_numpy(mask).to(dev),
                    chunk_row=torch.from_numpy(rows).to(dev),
                    width=int(width))


def build_tiles(g, bm: int = 128, bk: int = 128, eb: int = 256) -> TilePack:
    """Bucket the edges of ``g`` by (dst // bm, src // bk) tile pair."""
    h = g.host
    src = h.src.astype(np.int64)
    dst = h.dst.astype(np.int64)
    eid = h.eid.astype(np.int64)
    n_tiles_m = max(1, -(-g.n_dst // bm))
    n_tiles_k = max(1, -(-g.n_src // bk))
    mi, ki = dst // bm, src // bk
    # sort by (mi, ki, dst, src): groups the buckets and keeps the
    # paper's ascending-address stream inside each
    order = np.lexsort((src, dst, ki, mi))
    src, dst, eid, mi, ki = (a[order] for a in (src, dst, eid, mi, ki))
    key = mi * n_tiles_k + ki
    change = np.nonzero(np.diff(key))[0] + 1
    seg_s = np.concatenate([[0], change]).astype(np.int64)
    seg_e = np.concatenate([change, [key.size]]).astype(np.int64)
    if key.size == 0:
        seg_s = seg_e = np.zeros(0, np.int64)
    n_ch = -(-(seg_e - seg_s) // eb)
    seg = np.repeat(np.arange(seg_s.size), n_ch)
    k = np.arange(seg.size) - np.repeat(np.cumsum(n_ch) - n_ch, n_ch)
    starts = seg_s[seg] + k * eb
    lens = np.minimum(eb, seg_e[seg] - starts)
    T = max(seg.size, 1)

    tm = np.zeros(T, np.int32)
    tk = np.zeros(T, np.int32)
    dl = np.zeros((T, eb), np.int32)
    sl = np.zeros((T, eb), np.int32)
    ei = np.zeros((T, eb), np.int32)
    mask = np.zeros((T, eb), bool)
    if seg.size:
        tm[:] = mi[starts]
        tk[:] = ki[starts]
        mask[:] = np.arange(eb)[None, :] < lens[:, None]
        idx = np.minimum(starts[:, None] + np.arange(eb)[None, :],
                         key.size - 1)
        dl[:] = np.where(mask, dst[idx] - tm[:, None].astype(np.int64) * bm,
                         0)
        sl[:] = np.where(mask, src[idx] - tk[:, None].astype(np.int64) * bk,
                         0)
        ei[:] = np.where(mask, eid[idx], 0)
    # tile_m is non-decreasing: a bucket is its M-tile's first where the
    # tile changes
    first = np.ones(T, np.int32)
    first[1:] = (tm[1:] != tm[:-1]).astype(np.int32)

    dev = g.device

    def up(a):
        return torch.from_numpy(a).to(dev)

    return TilePack(tile_m=up(tm), tile_k=up(tk), first_of_m=up(first),
                    dst_local=up(dl), src_local=up(sl), eids=up(ei),
                    mask=up(mask), bm=bm, bk=bk, eb=eb, n_dst=g.n_dst,
                    n_src=g.n_src, n_tiles_m=n_tiles_m, n_tiles_k=n_tiles_k)
