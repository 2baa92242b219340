"""GNN inference serving tier (port of ``repro/core/serving.py``).

* :class:`MicroBatcher` coalesces node-id requests onto a small fixed set
  of padded *signature classes*; a :class:`SignatureTracker` holds the
  server to that bounded set.
* **Layer-wise full-neighbor inference**: each :meth:`GNNServer.refresh`
  computes every layer once for ALL nodes — the app's full-graph
  ``infer``, so the CUDA kernels on the card — and requests are answered
  by row lookups. Exact by construction.
* :class:`FeatureCache` is the hot-node tier over the output table: a
  degree-ordered pinned set over an LRU, with exact accounting
  (:class:`CacheStats`).

Modes: ``layerwise``, and ``auto``, which resolves to layerwise — what
the JAX planner's serve cost picks for full-neighbor fan-out at these
sizes. The fan-out mode (blocks + sampler) is ROADMAP A10, R-GCN is A11;
the spans, metrics and drift hooks of the JAX server are A8.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.pipeline import prefetch
from ..device import DeviceLike, resolve_device
from ..models.gnn import gat, gcn, sage
from ..models.gnn.common import make_bundle
from ..obs.signatures import SignatureTracker

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
    never served.
    """

    def __init__(self, store: np.ndarray, capacity: int,
                 pinned: Optional[np.ndarray] = None):
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
SERVE_APPS = ("gcn", "sage", "gat")
SERVE_MODES = ("layerwise",)
_QUEUED_MODES = {"fanout": "ROADMAP A10 (fan-out serving with blocks and "
                           "the neighbor sampler)"}


class GNNServer:
    """Micro-batched layer-wise GNN inference over one graph.

    ``app``: 'gcn' | 'sage' | 'gat'; ``model`` is the app's module
    (``init`` or ``from_jax_params``); ``g`` the graph and ``feats`` the
    (n, d) host feature array. The graph, model and features are placed
    on ``device``; a CUDA device runs the refresh through the kernels.
    The refresh calls each app's ``infer`` with its defaults, so GAT
    serves the multipass pipeline (gSDDMM logits, composed edge softmax),
    as the JAX server does.
    """

    def __init__(self, app: str, model, g, feats, *, mode: str = "auto",
                 classes: Sequence[int] = (8, 32, 128),
                 cache_rows: int = 4096, pin_hot: int = 256,
                 device: DeviceLike = "cuda"):
        if app == "rgcn":
            raise NotImplementedError(
                "app 'rgcn' is not ported yet: ROADMAP A11 (relational apps)")
        if app not in SERVE_APPS:
            raise ValueError(f"unknown serve app {app!r}; expected one of "
                             f"{SERVE_APPS}")
        if mode in _QUEUED_MODES:
            raise NotImplementedError(
                f"serve mode {mode!r} is not ported yet: "
                f"{_QUEUED_MODES[mode]}")
        if mode not in ("auto",) + SERVE_MODES:
            raise ValueError(f"unknown serve mode {mode!r}; expected 'auto' "
                             f"or one of {SERVE_MODES}")
        if g is None:
            raise ValueError("plain-graph apps need g")
        self.device = resolve_device(device)
        self.app = app
        self.model = model.to(self.device)
        self.mode = mode
        self.batcher = MicroBatcher(classes)
        self.g = g.to(self.device)
        self.bundle = make_bundle(self.g)
        self._full_fn = {"gcn": gcn, "sage": sage, "gat": gat}[app].infer
        self.feats = np.asarray(feats, np.float32)
        self.x_device = torch.from_numpy(
            np.ascontiguousarray(self.feats)).to(self.device)
        self.cache_rows = int(cache_rows)
        self._hot = hot_node_ids(self.g.host.in_degrees, pin_hot)

        # one signature per (class, mode) is the whole budget
        self.tracker = SignatureTracker(
            limit=len(self.batcher.classes) * len(SERVE_MODES), name="serve")
        self.compiles = 0
        self.refreshes = 0
        self.served_batches = 0
        self.served_requests = 0
        self._out_cache: Optional[FeatureCache] = None

    def mode_for_class(self, cls: int) -> str:
        """Serve mode of class ``cls``: layer-wise for every class (the
        only mode of this slice, and what 'auto' resolves to)."""
        return "layerwise"

    # -- layer-wise plan ------------------------------------------------ #
    def refresh(self) -> CacheStats:
        """Recompute the output table (each layer once, for all nodes, on
        the server's device) and push it through the hot-node cache
        without dropping counters."""
        logits = self._full_fn(self.model, self.bundle, self.x_device)
        store = logits.cpu().numpy()          # waits for the device
        self.refreshes += 1
        if self._out_cache is None:
            self._out_cache = FeatureCache(store, self.cache_rows,
                                           pinned=self._hot)
        else:
            self._out_cache.replace_store(store)
        return self._out_cache.stats()

    def update_features(self, ids, rows) -> None:
        """Write new input features and recompute the output table — a
        stale output row is a wrong prediction."""
        ids = np.asarray(ids).reshape(-1)
        rows = np.asarray(rows, np.float32).reshape(len(ids), -1)
        self.feats[ids] = rows
        self.x_device[torch.from_numpy(ids).to(self.device)] = (
            torch.from_numpy(rows).to(self.device))
        if self._out_cache is not None:
            self.refresh()

    # -- serving -------------------------------------------------------- #
    def _observe(self, signature: Tuple) -> None:
        if self.tracker.observe_checked(signature):
            self.compiles += 1

    def serve_batch(self, batch: MicroBatch) -> np.ndarray:
        """(n_real, n_out) predictions for one coalesced batch."""
        mode = self.mode_for_class(batch.cls)
        if self._out_cache is None:
            self.refresh()
        self._observe((mode, batch.cls))
        out = self._out_cache.lookup(batch.ids[:batch.n_real])
        self.served_batches += 1
        return out

    def serve(self, requests: Sequence[Tuple[int, Sequence[int]]]
              ) -> Dict[int, np.ndarray]:
        """Serve ``(rid, node_ids)`` requests; returns rid → (len(ids),
        n_out) predictions, padded rows never included."""
        batches = self.batcher.coalesce(requests)
        results: Dict[int, List[np.ndarray]] = {}
        for batch in batches:
            vals = self.serve_batch(batch)
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
            reqs = next(it, sentinel)
            if reqs is sentinel:
                break
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
            "out_cache": (self._out_cache.stats()
                          if self._out_cache is not None else None),
        }
