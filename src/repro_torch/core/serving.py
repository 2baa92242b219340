"""GNN inference serving tier (port of ``repro/core/serving.py``).

* :class:`MicroBatcher` coalesces node-id requests onto a small fixed set
  of padded *signature classes*; a :class:`SignatureTracker` holds the
  server to that bounded set.
* **Layer-wise full-neighbor inference**: each :meth:`GNNServer.refresh`
  computes every layer once for ALL nodes — the app's full-graph
  ``infer``, so the CUDA kernels on the card — and requests are answered
  by row lookups. Exact by construction.
* **Fan-out inference**: each batch samples its L-hop blocks
  (:class:`~repro_torch.data.NeighborSampler`, one per class, seeded),
  pulls their input rows through a feature cache and runs the app's
  ``infer_blocks`` (the kernels again, on each block graph). Exact when
  ``fanout`` ≥ the max in-degree, the default.
* :class:`FeatureCache` is the hot-node tier over the output table
  (layer-wise) and the input features (fan-out): a degree-ordered pinned
  set over an LRU, with exact accounting (:class:`CacheStats`).

Each class resolves to a mode once, via
:func:`~repro_torch.core.planner.plan_serve`, as the JAX server resolves
it. The server reports through ``repro_torch.obs`` as the JAX server
does: the spans ``serve.intake`` / ``serve.handle`` (the two top-level
spans of :meth:`GNNServer.run`, which tile a session), ``serve.batching``,
``serve.refresh``, ``serve.cache_lookup``, ``serve.sample``,
``serve.infer`` and ``serve.respond``; the ``serve.batch_seconds``
histogram with the measured ``serve:infer`` event per batch; and each
cache's hit / miss / eviction counters (``serve.cache.<name>.*``).
R-GCN serves over its typed graph, as the JAX server serves it: a
refresh runs ``rgcn.infer`` on the :class:`~repro_torch.core.hetero.RelGraph`,
and fan-out samples the merged graph with each edge's relation.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.pipeline import prefetch
from ..data.sampler import MiniBatch, NeighborSampler
from ..device import DeviceLike, resolve_device
from ..models.gnn import gat, gcn, rgcn, sage
from ..models.gnn.common import make_bundle
from ..obs import metrics as _obs_metrics
from ..obs.events import measured_event
from ..obs.signatures import SignatureTracker
from ..obs.spans import span
from . import planner
from .blocks import serve_block_signature

__all__ = ["CacheStats", "FeatureCache", "MicroBatch", "MicroBatcher",
           "GNNServer", "hot_node_ids", "SERVE_APPS", "SERVE_MODES"]


# --------------------------------------------------------------------- #
# hot-node cache tier
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Exact cache accounting."""
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    pinned_hits: int = 0
    size: int = 0          # resident LRU rows (excludes the pinned set)
    pinned: int = 0
    capacity: int = 0

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    @property
    def hit_ratio(self) -> float:
        n = self.lookups
        return float(self.hits) / n if n else 0.0


def hot_node_ids(degrees, k: int) -> np.ndarray:
    """The ``k`` highest-degree node ids, degree-ordered (descending,
    ties broken by id) — the pinned hot set."""
    deg = np.asarray(degrees)
    k = min(int(k), deg.shape[0])
    if k <= 0:
        return np.empty(0, np.int64)
    order = np.lexsort((np.arange(deg.shape[0]), -deg))
    return order[:k].astype(np.int64)


class FeatureCache:
    """Hot-row cache over a host-side backing row store.

    ``store`` is the authoritative (n, d) array. ``pinned`` rows are
    resident forever and do not count against ``capacity``; everything
    else goes through an LRU of at most ``capacity`` rows. Duplicate ids
    inside one lookup hit on the second occurrence. :meth:`update`
    writes the store AND refreshes any resident copy, so a stale row is
    never served. A ``name`` reports each lookup's hits, misses and
    evictions to the registry counters ``serve.cache.<name>.*``.
    """

    def __init__(self, store: np.ndarray, capacity: int,
                 pinned: Optional[np.ndarray] = None,
                 name: Optional[str] = None):
        self.name = name
        self.store = np.asarray(store)
        if self.store.ndim < 1:
            raise ValueError("store must be at least 1-D (rows)")
        self.capacity = int(capacity)
        if self.capacity < 0:
            raise ValueError("capacity must be ≥ 0")
        self._pinned: Dict[int, np.ndarray] = {}
        if pinned is not None:
            for i in np.asarray(pinned).reshape(-1):
                self._pinned[int(i)] = self.store[int(i)].copy()
        self._lru: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.pinned_hits = 0

    @property
    def pinned_ids(self) -> Tuple[int, ...]:
        return tuple(self._pinned)

    def resident(self, i: int) -> bool:
        """Is row ``i`` currently served without touching the store?"""
        return int(i) in self._pinned or int(i) in self._lru

    def lookup(self, ids) -> np.ndarray:
        """Rows for ``ids`` (any order, duplicates fine), with exact
        hit/miss/eviction accounting."""
        ids = np.asarray(ids).reshape(-1)
        out = np.empty((ids.shape[0],) + self.store.shape[1:],
                       self.store.dtype)
        h0, m0, e0 = self.hits, self.misses, self.evictions
        for j, raw in enumerate(ids):
            i = int(raw)
            row = self._pinned.get(i)
            if row is not None:
                self.hits += 1
                self.pinned_hits += 1
                out[j] = row
                continue
            row = self._lru.get(i)
            if row is not None:
                self.hits += 1
                self._lru.move_to_end(i)
                out[j] = row
                continue
            self.misses += 1
            row = self.store[i].copy()
            out[j] = row
            if self.capacity > 0:
                self._lru[i] = row
                if len(self._lru) > self.capacity:
                    self._lru.popitem(last=False)
                    self.evictions += 1
        if self.name is not None:
            pre = f"serve.cache.{self.name}"
            _obs_metrics.counter(f"{pre}.hits").inc(self.hits - h0)
            _obs_metrics.counter(f"{pre}.misses").inc(self.misses - m0)
            _obs_metrics.counter(
                f"{pre}.evictions").inc(self.evictions - e0)
        return out

    def update(self, ids, rows) -> None:
        """Write ``rows`` into the store and refresh resident copies in
        place — a later lookup never sees the old value."""
        ids = np.asarray(ids).reshape(-1)
        rows = np.asarray(rows, self.store.dtype)
        rows = rows.reshape((ids.shape[0],) + self.store.shape[1:])
        for j, raw in enumerate(ids):
            i = int(raw)
            self.store[i] = rows[j]
            if i in self._pinned:
                self._pinned[i] = rows[j].copy()
            if i in self._lru:      # refresh, keep recency unchanged
                self._lru[i] = rows[j].copy()

    def invalidate(self, ids=None) -> None:
        """Drop LRU residency (all rows when ``ids`` is None); pinned rows
        re-read the store instead of dropping out."""
        if ids is None:
            self._lru.clear()
            for i in self._pinned:
                self._pinned[i] = self.store[i].copy()
            return
        for raw in np.asarray(ids).reshape(-1):
            i = int(raw)
            self._lru.pop(i, None)
            if i in self._pinned:
                self._pinned[i] = self.store[i].copy()

    def replace_store(self, store: np.ndarray) -> None:
        """Swap the backing store (a refresh writing new outputs) and
        refresh every resident row — counters survive, staleness does
        not."""
        store = np.asarray(store)
        if store.shape != self.store.shape:
            raise ValueError(f"replacement store shape {store.shape} != "
                             f"{self.store.shape}")
        self.store = store
        for i in self._pinned:
            self._pinned[i] = store[i].copy()
        for i in self._lru:
            self._lru[i] = store[i].copy()

    def stats(self) -> CacheStats:
        return CacheStats(hits=self.hits, misses=self.misses,
                          evictions=self.evictions,
                          pinned_hits=self.pinned_hits,
                          size=len(self._lru), pinned=len(self._pinned),
                          capacity=self.capacity)


# --------------------------------------------------------------------- #
# request micro-batching onto signature classes
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class MicroBatch:
    """One padded batch: ``ids[:n_real]`` are request node ids (caller
    order), the tail is pad (-1). ``spans`` maps each member request to
    its ``[start, stop)`` row range, so pad rows never reach a response."""
    ids: np.ndarray                      # (cls,) int64, -1 past n_real
    n_real: int
    cls: int                             # the padded signature class
    spans: Tuple[Tuple[int, int, int], ...]   # (rid, start, stop)


class MicroBatcher:
    """Coalesce request streams into signature-class batches.

    A batch of ``n`` real rows pads to the smallest class ≥ n; requests
    pack in arrival order and flush when the next one would overflow the
    largest class; a request larger than the largest class splits into
    largest-class chunks.
    """

    def __init__(self, classes: Sequence[int] = (8, 32, 128)):
        cls = sorted(int(c) for c in classes)
        if not cls or cls[0] < 1:
            raise ValueError("classes must be ≥ 1")
        if len(set(cls)) != len(cls):
            raise ValueError("classes must be unique")
        self.classes = tuple(cls)

    def assign_class(self, n: int) -> int:
        """Smallest class that fits ``n`` real rows (the largest class
        for anything bigger — the caller chunks)."""
        if n < 1:
            raise ValueError("empty batch has no class")
        for c in self.classes:
            if n <= c:
                return c
        return self.classes[-1]

    def _emit(self, members: List[Tuple[int, np.ndarray]]) -> MicroBatch:
        n_real = sum(len(ids) for _, ids in members)
        cls = self.assign_class(n_real)
        ids = np.full(cls, -1, np.int64)
        spans = []
        at = 0
        for rid, req_ids in members:
            ids[at:at + len(req_ids)] = req_ids
            spans.append((rid, at, at + len(req_ids)))
            at += len(req_ids)
        return MicroBatch(ids=ids, n_real=n_real, cls=cls,
                          spans=tuple(spans))

    def coalesce(self, requests: Sequence[Tuple[int, Sequence[int]]]
                 ) -> List[MicroBatch]:
        """Pack ``(rid, node_ids)`` requests into padded class batches,
        preserving arrival order within and across batches."""
        cap = self.classes[-1]
        batches: List[MicroBatch] = []
        members: List[Tuple[int, np.ndarray]] = []
        n = 0
        for rid, req_ids in requests:
            req_ids = np.asarray(req_ids, np.int64).reshape(-1)
            if req_ids.size == 0:
                raise ValueError(f"request {rid}: empty node-id list")
            if (req_ids < 0).any():
                raise ValueError(f"request {rid}: negative node id")
            while req_ids.size > cap:
                if members:
                    batches.append(self._emit(members))
                    members, n = [], 0
                batches.append(self._emit([(int(rid), req_ids[:cap])]))
                req_ids = req_ids[cap:]
            if n + req_ids.size > cap and members:
                batches.append(self._emit(members))
                members, n = [], 0
            members.append((int(rid), req_ids))
            n += req_ids.size
        if members:
            batches.append(self._emit(members))
        return batches

    @staticmethod
    def unpack(batch: MicroBatch, values: np.ndarray
               ) -> Dict[int, np.ndarray]:
        """Slice per-request responses out of a batch result; only rows
        < ``n_real`` are reachable through the spans."""
        if values.shape[0] < batch.n_real:
            raise ValueError(f"batch result has {values.shape[0]} rows "
                             f"< {batch.n_real} real requests")
        return {rid: values[start:stop]
                for rid, start, stop in batch.spans}


# --------------------------------------------------------------------- #
# the server
# --------------------------------------------------------------------- #
SERVE_APPS = ("gcn", "sage", "gat", "rgcn")
SERVE_MODES = planner.SERVE_MODES


class GNNServer:
    """Micro-batched GNN inference over one (plain or typed) graph.

    ``app``: 'gcn' | 'sage' | 'gat' with the graph ``g``, or 'rgcn' with
    ``rels`` — per-relation ``(src, dst)`` host pairs — and ``g`` None
    (or a graph whose ``n_src`` gives the node count); ``model`` is the
    app's module (``init`` or ``from_jax_params``) and ``feats`` the (n,
    d) host feature array. The graph, model and features are placed on
    ``device``; a CUDA device runs both modes through the kernels.

    Each class resolves to a mode once (``mode='auto'``: the cheaper by
    :func:`~repro_torch.core.planner.plan_serve`):

    * ``layerwise`` — :meth:`refresh` calls the app's ``infer`` with its
      defaults (GAT multipass, as the JAX server), requests are row
      lookups through the output cache;
    * ``fanout`` — each batch samples ``fanout`` in-edges per node per
      layer (default: the max in-degree, every in-edge, so exact) with a
      per-class sampler seeded with ``seed``, and runs ``infer_blocks``.

    ``refresh_batches`` is the number of batches a refresh is amortized
    over in the planner's cost. Every served batch's static signature
    feeds a :class:`SignatureTracker` bounded by ``len(classes)`` per
    mode.
    """

    def __init__(self, app: str, model, g, feats, *,
                 rels: Optional[Sequence] = None, mode: str = "auto",
                 classes: Sequence[int] = (8, 32, 128),
                 fanout: Optional[int] = None,
                 cache_rows: int = 4096, pin_hot: int = 256,
                 refresh_batches: int = 1024, seed: int = 0,
                 device: DeviceLike = "cuda"):
        if app not in SERVE_APPS:
            raise ValueError(f"unknown serve app {app!r}; expected one of "
                             f"{SERVE_APPS}")
        if mode not in ("auto",) + SERVE_MODES:
            raise ValueError(f"unknown serve mode {mode!r}; expected 'auto' "
                             f"or one of {SERVE_MODES}")
        self.device = resolve_device(device)
        self.app = app
        self.model = model.to(self.device)
        self.mode = mode
        self.batcher = MicroBatcher(classes)
        self.refresh_batches = int(refresh_batches)
        self.seed = int(seed)
        self.edge_rel = None
        self.bundle = self.rg = None
        if app == "rgcn":
            if rels is None:
                raise ValueError("app='rgcn' needs rels=[(src, dst), ...]")
            n = int(g.n_src) if g is not None else int(max(
                max(np.max(s), np.max(d)) for s, d in rels)) + 1
            self.g, self.edge_rel = rgcn.merged_graph(rels, n, self.device)
            self.rg = rgcn.build_relgraph(rels, n, self.device)
            self._graph_arg = self.rg
            mod = rgcn
        else:
            if g is None:
                raise ValueError("plain-graph apps need g")
            self.g = g.to(self.device)
            self.bundle = self._graph_arg = make_bundle(self.g)
            mod = {"gcn": gcn, "sage": sage, "gat": gat}[app]
        self._full_fn = mod.infer
        self._blocks_fn = mod.infer_blocks
        self.feats = np.asarray(feats, np.float32)
        self.x_device = torch.from_numpy(
            np.ascontiguousarray(self.feats)).to(self.device)
        self.n_layers = len(self.model.layers)
        deg = self.g.host.in_degrees
        max_deg = int(deg.max()) if deg.size else 0
        # full-neighbor default: keep every in-edge, so serving is exact
        self.fanout = int(fanout) if fanout is not None else max(max_deg, 1)
        self.cache_rows = int(cache_rows)
        self._hot = hot_node_ids(deg, pin_hot)

        # one signature per (class, mode) is the whole budget
        self.tracker = SignatureTracker(
            limit=len(self.batcher.classes) * len(SERVE_MODES), name="serve")
        self.compiles = 0
        self.refreshes = 0
        self.served_batches = 0
        self.served_requests = 0
        self.mode_batches = {m: 0 for m in SERVE_MODES}
        self._out_cache: Optional[FeatureCache] = None
        self._feat_cache: Optional[FeatureCache] = None
        self._samplers: Dict[int, NeighborSampler] = {}
        self._mode_by_class: Dict[int, str] = {}

    # -- planning ------------------------------------------------------- #
    def _expansion_edges(self, cls: int) -> int:
        """Static edge-slot count of one fan-out batch of class ``cls``
        (the per-request re-expansion work the layer-wise plan avoids)."""
        return sum(sig[2] for sig in serve_block_signature(
            cls, self.fanout, self.n_layers))

    def mode_for_class(self, cls: int) -> str:
        """Serve mode of class ``cls``, planned once and cached."""
        chosen = self._mode_by_class.get(cls)
        if chosen is None:
            chosen = planner.plan_serve(
                (self.g.n_src, self.g.n_edges, int(cls), self.n_layers),
                "infer", requested=self.mode,
                expansion_edges=self._expansion_edges(cls),
                refresh_batches=self.refresh_batches,
                device="cuda" if self.device.type == "cuda" else "cpu")
            self._mode_by_class[cls] = chosen
        return chosen

    # -- layer-wise plan ------------------------------------------------ #
    def refresh(self) -> CacheStats:
        """Recompute the output table (each layer once, for all nodes, on
        the server's device) and push it through the hot-node cache
        without dropping counters."""
        with span("serve.refresh") as sp:
            logits = self._full_fn(self.model, self._graph_arg,
                                   self.x_device)
            sp.fence(logits)
        with span("serve.refresh_store"):
            store = logits.cpu().numpy()
            self.refreshes += 1
            if self._out_cache is None:
                self._out_cache = FeatureCache(store, self.cache_rows,
                                               pinned=self._hot, name="out")
            else:
                self._out_cache.replace_store(store)
        return self._out_cache.stats()

    def update_features(self, ids, rows) -> None:
        """Write new input features (through the fan-out path's cache, so
        it never serves a stale row) and recompute the layer-wise table —
        a stale output row is a wrong prediction."""
        ids = np.asarray(ids).reshape(-1)
        rows = np.asarray(rows, np.float32).reshape(len(ids), -1)
        if self._feat_cache is not None:
            self._feat_cache.update(ids, rows)     # writes self.feats too
        else:
            self.feats[ids] = rows
        self.x_device[torch.from_numpy(ids).to(self.device)] = (
            torch.from_numpy(rows).to(self.device))
        if self._out_cache is not None:
            self.refresh()

    # -- fan-out plan --------------------------------------------------- #
    def _sampler(self, cls: int) -> NeighborSampler:
        s = self._samplers.get(cls)
        if s is None:
            s = NeighborSampler(self.g, [self.fanout] * self.n_layers,
                                batch_size=cls, seed=self.seed,
                                edge_rel=self.edge_rel, device=self.device)
            self._samplers[cls] = s
        return s

    def _feature_rows(self, ids: np.ndarray) -> torch.Tensor:
        """Input features for padded global ids, pulled through the
        hot-node cache (-1 pads read as zero rows), on the device."""
        if self._feat_cache is None:
            self._feat_cache = FeatureCache(self.feats, self.cache_rows,
                                            pinned=self._hot, name="feat")
        ids = np.asarray(ids)
        x = np.zeros((ids.shape[0], self.feats.shape[1]), np.float32)
        real = ids >= 0
        if real.any():
            with span("serve.cache_lookup", args={"cache": "feat"}):
                x[real] = self._feat_cache.lookup(ids[real])
        return torch.from_numpy(x).to(self.device)

    def _infer_blocks(self, mb: MiniBatch, x: torch.Tensor) -> np.ndarray:
        with span("serve.infer", args={"cls": mb.seed_ids.shape[0]}) as sp:
            out = self._blocks_fn(self.model, mb.blocks, x)
            sp.fence(out)
        return out.cpu().numpy()

    def _serve_fanout(self, batch: MicroBatch) -> np.ndarray:
        sampler = self._sampler(batch.cls)
        with span("serve.sample", args={"cls": batch.cls}):
            mb = sampler.sample(batch.ids[:batch.n_real],
                                np.zeros(batch.n_real, np.int64))
        x = self._feature_rows(mb.input_ids_host)
        self._observe(("fanout", batch.cls) + mb.shape_signature())
        return self._infer_blocks(mb, x)[:batch.n_real]

    # -- serving -------------------------------------------------------- #
    def _observe(self, signature: Tuple) -> None:
        if self.tracker.observe_checked(signature):
            self.compiles += 1

    def serve_batch(self, batch: MicroBatch) -> np.ndarray:
        """(n_real, n_out) predictions for one coalesced batch."""
        t0 = time.perf_counter()
        mode = self.mode_for_class(batch.cls)
        if mode == "layerwise":
            if self._out_cache is None:
                self.refresh()
            self._observe(("layerwise", batch.cls))
            with span("serve.cache_lookup", args={"cache": "out",
                                                  "cls": batch.cls}):
                out = self._out_cache.lookup(batch.ids[:batch.n_real])
        else:
            out = self._serve_fanout(batch)
        self.served_batches += 1
        self.mode_batches[mode] += 1
        # the batch latency (out is on the host here: nothing in flight)
        dt = time.perf_counter() - t0
        measured_event("serve:infer", dt)
        _obs_metrics.histogram("serve.batch_seconds").observe(dt)
        return out

    def serve(self, requests: Sequence[Tuple[int, Sequence[int]]]
              ) -> Dict[int, np.ndarray]:
        """Serve ``(rid, node_ids)`` requests; returns rid → (len(ids),
        n_out) predictions, padded rows never included."""
        with span("serve.batching"):
            batches = self.batcher.coalesce(requests)
        results: Dict[int, List[np.ndarray]] = {}
        for batch in batches:
            vals = self.serve_batch(batch)
            with span("serve.respond"):
                for rid, rows in self.batcher.unpack(batch, vals).items():
                    results.setdefault(rid, []).append(rows)
        self.served_requests += len(results)
        # a request split across largest-class chunks re-assembles here
        return {rid: parts[0] if len(parts) == 1
                else np.concatenate(parts, axis=0)
                for rid, parts in results.items()}

    def serve_requests(self, reqs) -> None:
        """Complete a list of :class:`~repro_torch.data.ServeRequest`s:
        compute, then fulfil each future."""
        try:
            out = self.serve([(r.rid, r.ids) for r in reqs])
        except Exception as e:                     # noqa: BLE001
            for r in reqs:
                r.set_error(e)
            return
        for r in reqs:
            r.set_result(out[r.rid])

    def run(self, request_queue, depth: int = 2) -> None:
        """Drain a :class:`~repro_torch.data.RequestQueue` until it
        closes, with the coalescing window riding the prefetcher."""
        it = iter(prefetch(request_queue, depth=depth))
        sentinel = object()
        while True:
            # intake (blocking on the coalescing window) and handling are
            # the two top-level spans: together they tile the session
            with span("serve.intake"):
                reqs = next(it, sentinel)
            if reqs is sentinel:
                break
            with span("serve.handle"):
                self.serve_requests(reqs)

    def warmup(self) -> None:
        """Serve one batch of every signature class, so steady state
        never meets a new signature (and the table is computed)."""
        for cls in self.batcher.classes:
            batch = MicroBatch(ids=np.concatenate(
                                   [np.zeros(1, np.int64),
                                    np.full(cls - 1, -1, np.int64)]),
                               n_real=1, cls=cls, spans=((0, 0, 1),))
            self.serve_batch(batch)

    def stats(self) -> Dict:
        """Serving counters + cache stats."""
        return {
            "served_batches": self.served_batches,
            "served_requests": self.served_requests,
            "signatures": len(self.tracker.seen),
            "compiles": self.compiles,
            "refreshes": self.refreshes,
            "mode_batches": dict(self.mode_batches),
            "out_cache": (self._out_cache.stats()
                          if self._out_cache is not None else None),
            "feat_cache": (self._feat_cache.stats()
                           if self._feat_cache is not None else None),
        }
