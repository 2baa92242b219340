"""Neighbor sampling into fixed-shape blocks (port of
``repro/data/sampler.py``).

Per layer l, a bipartite block graph from sampled frontier nodes to the
previous frontier, padded to static shapes exactly as the JAX sampler
pads them:

* node pads go into a trailing *dummy source slot* whose features are
  zero (global id -1 reads a zero row);
* edge pads go into a trailing *dummy destination row*, so real rows'
  in-degrees — and therefore mean aggregation — are untouched.

Each block carries the dense uniform neighbor table of
:class:`repro_torch.core.blocks.BlockGraph` and the per-edge GCN weights
from the FULL graph's degrees (0 on pad edges). A sampler made with
``reverse=True`` (the trainer's) also builds each block's Gᵀ in
:meth:`~NeighborSampler.build`, on the host, from the draw's own edge
order (``core/graph.reverse_from_draw``; its canonical order is the JAX
sampler's reverse table): the block VJP pulls over it. With ``edge_rel``
it also builds each block's relation-expanded Gᵀ there
(``core/hetero.block_expanded_reverse``), which the relational block
VJP's kernel backward runs B1 over. A serving sampler builds none; a
block's Gᵀ is then made on first use.

The draw (``_sample_layer``) and the slot numbering are the JAX
sampler's, line for line, on host numpy: one seed gives bit-identical
blocks in both packages. :meth:`NeighborSampler.sample` draws on the host
(:meth:`~NeighborSampler.draw`), then builds each block's
:class:`~repro_torch.core.graph.Graph` and tensors on the sampler's
``device`` (:meth:`~NeighborSampler.build`).

Sampling is uniform WITHOUT replacement; a node with in-degree ≤ fanout
keeps all its in-edges, so with ``fanout ≥ max in-degree`` the blocks
reproduce the full graph exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.blocks import BlockGraph
from ..core.graph import Graph, from_coo, reverse_from_draw
from ..core.hetero import block_expanded_reverse
from ..device import DeviceLike, resolve_device

__all__ = ["SampledBlock", "MiniBatch", "NeighborSampler"]


@dataclasses.dataclass(frozen=True, eq=False)
class SampledBlock:
    """One bipartite layer of a minibatch (outer hop = larger side).

    ``bg`` holds the padded block graph, its uniform neighbor table and
    (built on first use) the src-sorted reverse table; ``src_ids`` the
    global node id per source slot (-1 = pad), ``src_ids_host`` the same
    ids as host int64
    (what a feature lookup reads, without a device round trip);
    ``gcn_norm`` per-edge 1/√(deg_out(u)·deg_in(v)) from the FULL graph's
    degrees, caller edge order, 0 on pad edges. With ``edge_rel``,
    ``rel`` is each edge's relation id and ``rel_norm`` the
    per-(destination, relation) sampled-mean weight (both 0 on pads).
    """
    bg: BlockGraph
    src_ids: torch.Tensor           # (n_src_pad,) int32, -1 = pad
    src_ids_host: np.ndarray        # (n_src_pad,) int64, -1 = pad
    gcn_norm: torch.Tensor          # (n_edges_pad,) float32, 0 on pads
    rel: Optional[torch.Tensor] = None        # (n_edges_pad,) int32
    rel_norm: Optional[torch.Tensor] = None   # (n_edges_pad,) float32


@dataclasses.dataclass(frozen=True, eq=False)
class MiniBatch:
    """Blocks (outermost hop first) + seeds. ``label_mask`` is False on
    pad seeds (a short final batch padded up to the batch size)."""
    blocks: Tuple[SampledBlock, ...]
    input_ids: torch.Tensor     # (n_input_pad,) global ids, -1 = pad
    seed_ids: torch.Tensor      # (batch,) global seed ids, -1 = pad
    labels: torch.Tensor        # (batch,) pad rows hold 0
    label_mask: torch.Tensor    # (batch,) bool

    @property
    def input_ids_host(self) -> np.ndarray:
        """``input_ids`` as host int64, without a device round trip."""
        return self.blocks[0].src_ids_host

    def shape_signature(self) -> Tuple:
        """Static padded-shape signature — identical for every batch of
        one sampler configuration."""
        return tuple(b.bg.signature for b in self.blocks)


@dataclasses.dataclass(frozen=True)
class _HostLayer:
    """One layer's block as drawn on the host, before any upload."""
    srcs: np.ndarray        # (n_edges_pad,) int64 source slots
    dsts: np.ndarray        # (n_edges_pad,) int64 destination rows
    n_src_pad: int
    n_dst: int
    fanout: int
    nbr: np.ndarray         # (n_dst, fanout) int32
    nbr_eid: np.ndarray     # (n_dst, fanout) int32
    nbr_mask: np.ndarray    # (n_dst, fanout) bool
    real_deg: np.ndarray    # (n_dst,) int32
    src_ids: np.ndarray     # (n_src_pad,) int64
    norms: np.ndarray       # (n_edges_pad,) float32
    rel: Optional[np.ndarray]
    rel_norm: Optional[np.ndarray]


@dataclasses.dataclass(frozen=True)
class HostMiniBatch:
    """A minibatch as drawn on the host (:meth:`NeighborSampler.draw`);
    :meth:`NeighborSampler.build` uploads it."""
    layers: Tuple[_HostLayer, ...]      # innermost (seed) layer first
    seeds: np.ndarray
    labels: np.ndarray
    n_real_seeds: int


class NeighborSampler:
    """Uniform without-replacement neighbor sampler over incoming edges.

    ``g`` is the port's :class:`~repro_torch.core.graph.Graph` (its host
    index arrays are read); blocks are built on ``device``, with each
    block's Gᵀ when ``reverse`` (for training). The stream is
    deterministic per seed, and draws the JAX sampler's numbers.
    """

    def __init__(self, g: Graph, fanouts: Sequence[int], batch_size: int,
                 seed: int = 0, edge_rel=None, device: DeviceLike = "cuda",
                 reverse: bool = False):
        self.device = resolve_device(device)
        self.reverse = bool(reverse)
        host = g.host
        self.indptr = np.asarray(host.indptr_dst, np.int64)
        self.src = np.asarray(host.src, np.int64)
        # relational sampling: per-edge relation ids (caller order) →
        # canonical order, so a sampled edge slot looks its type up
        if edge_rel is not None:
            edge_rel = np.asarray(edge_rel, np.int64)
            self.rel = edge_rel[np.asarray(host.eid)]
            self.n_rel = int(edge_rel.max()) + 1 if edge_rel.size else 0
        else:
            self.rel = None
            self.n_rel = 0
        self.fanouts = list(fanouts)
        self.batch_size = batch_size
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.n_nodes = max(g.n_src, g.n_dst)
        # persistent generation-stamped slot table: global ids map to
        # block-local slots in O(touched) per layer
        self._slot = np.zeros(self.n_nodes, np.int64)
        self._slot_gen = np.zeros(self.n_nodes, np.int64)
        self._gen = 0
        # full-graph degrees for GCN-style symmetric normalization
        self.deg_in = np.maximum(host.in_degrees.astype(np.float64), 1)
        self.deg_out = np.maximum(host.out_degrees.astype(np.float64), 1)
        # label masks depend only on the real-seed count: cache them on
        # the device instead of uploading one per batch
        self._mask_cache: Dict[int, torch.Tensor] = {}
        # static padded sizes per layer (innermost = batch itself)
        self.layer_sizes = [batch_size]
        for f in reversed(self.fanouts):
            self.layer_sizes.append(self.layer_sizes[-1] * (f + 1))

    def reset(self, seed: Optional[int] = None) -> None:
        """Re-seed the sampling stream (same seed ⇒ same batches)."""
        self.rng = np.random.default_rng(self.seed if seed is None
                                         else seed)

    # ------------------------------------------------------------------ #
    @staticmethod
    def _sample_layer(indptr, rng, frontier: np.ndarray, fanout: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched uniform without-replacement draw for one layer.

        Rows whose degree fits the fanout keep every in-edge in CSR order;
        over-fanout rows draw one random key per candidate edge slot,
        grouped into power-of-two degree classes, and keep the
        ``fanout`` smallest. Returns ``(kmask, eslot, take)``: the
        (n_rows, fanout) valid-sample mask, global edge slots (garbage
        where masked) and the per-row sample count.
        """
        n_rows = len(frontier)
        valid = frontier >= 0
        safe = np.where(valid, frontier, 0)
        lo = indptr[safe]
        deg = np.where(valid, indptr[safe + 1] - lo, 0)
        take = np.minimum(deg, fanout)
        pos = np.broadcast_to(np.arange(fanout, dtype=np.int64),
                              (n_rows, fanout)).copy()
        big = np.nonzero(deg > fanout)[0]
        if len(big):
            cls = np.ceil(np.log2(deg[big])).astype(np.int64)
            for c in np.unique(cls):
                r = big[cls == c]
                K = int(deg[r].max())
                keys = rng.random((len(r), K))
                keys[np.arange(K)[None, :] >= deg[r][:, None]] = np.inf
                pos[r] = np.argpartition(keys, fanout - 1,
                                         axis=1)[:, :fanout]
        kmask = np.arange(fanout)[None, :] < take[:, None]
        return kmask, lo[:, None] + pos, take

    def draw(self, seeds: np.ndarray, labels: np.ndarray,
             rng: Optional[np.random.Generator] = None) -> HostMiniBatch:
        """The host half of :meth:`sample`: every block's arrays, static
        shapes (node- AND edge-padded), nothing uploaded."""
        if rng is None:
            rng = self.rng
        seeds = np.asarray(seeds, np.int64)
        labels = np.asarray(labels, np.int64)
        n_real_seeds = len(seeds)
        if len(seeds) < self.batch_size:     # short final batch: pad seeds
            pad = self.batch_size - len(seeds)
            seeds = np.concatenate([seeds, np.full(pad, -1, np.int64)])
            labels = np.concatenate([labels, np.zeros(pad, np.int64)])

        layers: List[_HostLayer] = []
        frontier = seeds
        for li, fanout in enumerate(reversed(self.fanouts)):
            n_dst = self.layer_sizes[li]
            n_src_pad = self.layer_sizes[li + 1]
            n_edges_pad = n_dst * fanout
            kmask, eslot, _ = self._sample_layer(self.indptr, rng,
                                                 frontier, fanout)
            # real sampled edges in row-major (canonical) order
            jj, kk = np.nonzero(kmask)
            nbs = self.src[eslot[jj, kk]]
            # dst-first source numbering: src slot j == dst node j, so a
            # layer reads its destinations' own features as h[:n_dst].
            # First-occurrence slot table (reversed writes: first wins);
            # a stamp != current generation means "unassigned".
            self._gen += 1
            slot, gen = self._slot, self._slot_gen
            idxs = np.nonzero(frontier >= 0)[0]
            fv = frontier[idxs][::-1]
            slot[fv] = idxs[::-1]
            gen[fv] = self._gen
            # newly discovered neighbors, in first-occurrence order
            new_vals = nbs[gen[nbs] != self._gen]
            uvals, first = np.unique(new_vals, return_index=True)
            new_unique = uvals[np.argsort(first, kind="stable")]
            slot[new_unique] = n_dst + np.arange(len(new_unique))
            gen[new_unique] = self._gen
            n_real_src = n_dst + len(new_unique)
            # pad sources to static size; dummy source = last slot
            src_ids = np.concatenate([
                frontier, new_unique,
                np.full(n_src_pad - n_real_src, -1, np.int64)])
            srcs = slot[nbs]
            n_real = len(jj)
            nbr = np.full((n_dst, fanout), n_src_pad - 1, np.int32)
            nbr[jj, kk] = srcs
            nbr_eid = np.zeros((n_dst, fanout), np.int32)
            nbr_eid[jj, kk] = np.arange(n_real, dtype=np.int32)
            nbr_mask = kmask
            norms = (1.0 / np.sqrt(self.deg_out[nbs]
                                   * self.deg_in[frontier[jj]]))
            # pad edges into the dummy destination row n_dst (never any
            # real source slot: a pad edge exists only when some row is
            # under fanout, which leaves the dummy source slot free)
            pad = n_edges_pad - n_real
            srcs = np.concatenate([srcs,
                                   np.full(pad, n_src_pad - 1, np.int64)])
            dsts = np.concatenate([jj, np.full(pad, n_dst, np.int64)])
            norms = np.concatenate([norms,
                                    np.zeros(pad)]).astype(np.float32)
            # pad slots of the neighbor table index SOME valid edge id;
            # they are masked, so the value never reaches a reduction
            nbr_eid[~nbr_mask] = min(n_real, n_edges_pad - 1)
            real_deg = nbr_mask.sum(axis=1).astype(np.int32)
            rel_blk = rel_norm = None
            if self.rel is not None:
                # relation id per sampled edge + the per-(dst, relation)
                # sampled-mean weight 1/|sampled N_r(v)|; pads get 0 / 0
                rel_e = self.rel[eslot[jj, kk]]
                key = jj * self.n_rel + rel_e
                cnt = np.bincount(key,
                                  minlength=n_dst * max(self.n_rel, 1))
                rel_blk = np.concatenate(
                    [rel_e, np.zeros(pad, np.int64)]).astype(np.int32)
                rel_norm = np.concatenate(
                    [1.0 / cnt[key], np.zeros(pad)]).astype(np.float32)
            layers.append(_HostLayer(
                srcs=srcs, dsts=dsts, n_src_pad=n_src_pad, n_dst=n_dst,
                fanout=fanout, nbr=nbr, nbr_eid=nbr_eid, nbr_mask=nbr_mask,
                real_deg=real_deg, src_ids=src_ids, norms=norms,
                rel=rel_blk, rel_norm=rel_norm))
            frontier = src_ids
        return HostMiniBatch(layers=tuple(layers), seeds=seeds,
                             labels=labels, n_real_seeds=n_real_seeds)

    def build(self, hb: HostMiniBatch) -> MiniBatch:
        """The device half of :meth:`sample`: each block's
        :class:`~repro_torch.core.graph.Graph` (and, with ``reverse``,
        its Gᵀ) and tensors on ``self.device``, outermost hop first."""
        dev = self.device

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        blocks: List[SampledBlock] = []
        for hl in reversed(hb.layers):
            g = from_coo(hl.srcs, hl.dsts, n_src=hl.n_src_pad,
                         n_dst=hl.n_dst + 1, device=dev)
            if self.reverse:
                reverse_from_draw(g, hl.srcs, hl.dsts)
            bg = BlockGraph(g=g, nbr=put(hl.nbr), nbr_eid=put(hl.nbr_eid),
                            nbr_mask=put(hl.nbr_mask),
                            real_deg=put(hl.real_deg), n_dst_real=hl.n_dst,
                            fanout=hl.fanout)
            rel = None if hl.rel is None else put(hl.rel)
            if self.reverse and rel is not None:
                block_expanded_reverse(bg, rel, self.n_rel,
                                       (hl.srcs, hl.dsts, hl.rel))
            blocks.append(SampledBlock(
                bg=bg, src_ids=put(hl.src_ids.astype(np.int32)),
                src_ids_host=hl.src_ids, gcn_norm=put(hl.norms), rel=rel,
                rel_norm=None if hl.rel_norm is None else put(hl.rel_norm)))
        label_mask = self._mask_cache.get(hb.n_real_seeds)
        if label_mask is None:
            label_mask = put(np.arange(self.batch_size) < hb.n_real_seeds)
            self._mask_cache[hb.n_real_seeds] = label_mask
        return MiniBatch(blocks=tuple(blocks), input_ids=blocks[0].src_ids,
                         seed_ids=put(hb.seeds.astype(np.int32)),
                         labels=put(hb.labels.astype(np.int32)),
                         label_mask=label_mask)

    def sample(self, seeds: np.ndarray, labels: np.ndarray,
               rng: Optional[np.random.Generator] = None) -> MiniBatch:
        """Build fully static-shape (node- AND edge-padded) blocks.

        Each block graph has ``n_dst + 1`` destination rows; padded edges
        point at the extra dummy row, so real rows are untouched.
        Consumers slice ``[:n_dst]`` (``block_gspmm`` does it).
        """
        return self.build(self.draw(seeds, labels, rng))

    def batches(self, node_ids: np.ndarray, labels: np.ndarray,
                drop_last: bool = True) -> Iterator[MiniBatch]:
        """Shuffled minibatches. With ``drop_last=False`` the short final
        batch is padded up to ``batch_size`` (masked via ``label_mask``).

        The epoch is drawn from a child RNG seeded EAGERLY (one draw from
        the sampler stream per call, before the generator runs), so
        epoch k's batches depend only on the seed and k.
        """
        node_ids = np.asarray(node_ids)
        labels = np.asarray(labels)
        child = np.random.default_rng(int(self.rng.integers(2 ** 63)))

        def gen() -> Iterator[MiniBatch]:
            order = child.permutation(len(node_ids))
            stop = (len(order) - self.batch_size + 1 if drop_last
                    else len(order))
            for s in range(0, stop, self.batch_size):
                idx = order[s:s + self.batch_size]
                yield self.sample(node_ids[idx], labels[idx], rng=child)

        return gen()
