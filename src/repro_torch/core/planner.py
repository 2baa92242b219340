"""Unified execution-plan layer for the BR/CR lattice (port of
``repro/core/planner.py``).

Users never pick a kernel; the framework does. This module is that
selection layer:

* :class:`GraphStats` — host-side statistics of a graph (edge count,
  degree moments, skew, ELL padding estimate), computed once per graph
  from ``g.host.in_degrees`` when :func:`get_plan_cache` makes the
  graph's cache.
* :class:`PlanCache` — one per graph: its packs (``core/tiling.py``),
  each built at most once, on the host, at first use; the stats; and the
  autotuned decisions.
* :func:`plan_gspmm` — the planner proper: given a graph, a parsed
  ``BRSpec`` and operands, it picks an execution strategy by an explicit
  cost model (:func:`estimate_cost`), or measures the candidates once and
  caches the winner in autotune mode (:func:`set_mode`,
  ``REPRO_PLANNER_MODE=autotune``). A pinned strategy that cannot run a
  spec falls back down :data:`FALLBACK_CHAIN` (``kernel → onehot → ell →
  segment``) with a one-time warning instead of raising.
* The other plan rows, each memoized per static signature and keyed by
  the operands' device type: :func:`plan_block_gspmm` /
  :func:`plan_block_vjp` (sampled blocks, forward and backward),
  :func:`plan_hetero`, :func:`plan_sddmm`, :func:`plan_attention`,
  :func:`plan_serve`.

The port's ``"kernel"`` stands where JAX has ``"pallas"``: the CUDA
kernels B1–B5, which walk the CSR and need no pack. The cost row is
picked from the operands' device type (``"cpu"`` or ``"cuda"``), never
from a process global. The ``cpu`` rows are JAX's, so on the CPU the
port decides as JAX decides; the ``cuda`` row was fitted on an H100
(PERF.md §6, ``benchmarks/torch_planner_fit.py``).

``ring`` (partitioned execution, ``core/partition.py``) qualifies only
inside :func:`use_ring`, whose context holds the ``torch.distributed``
process group the shards live on, and only for a square graph; its cost
adds the exchange (``compression.wire_bytes`` at the context's wire
mode) to the per-device slot work of the partition's stats
(:meth:`PlanCache.partition`). Without a context — on one card, always —
auto never takes it and a pinned ``"ring"`` falls back to ``ell`` /
``segment``, as JAX's does without a mesh.

Every decision is recorded in a process-wide plan log (:func:`plan_log`)
and, with its predicted cost, in the plan-event stream
(``repro_torch.obs.events``) that :func:`drift_report` holds against the
measured times.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import warnings
import weakref
from collections import Counter
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..kernels.dispatch import kernel_supports, sddmm_kernel_supports
from ..obs import events as _obs_events
from ..obs import metrics as _obs_metrics
from ..obs.events import drift_report, plan_events  # noqa: F401 (re-export)
from ..obs.spans import _cuda_devices, fence
from ..optim.compression import wire_bytes as _wire_bytes
from .tiling import (ELLClass, ELLPack, TilePack, build_ell, build_ell_ragged,
                     build_ell_uniform, build_tiles)

__all__ = ["GraphStats", "PlanCache", "Plan", "get_plan_cache",
           "compute_stats", "estimate_cost", "ell_rowcomplete_padding",
           "plan_gspmm", "supports", "device_of", "dtype_name",
           "plan_log", "clear_plan_log", "last_plan", "pack_build_totals",
           "set_mode", "get_mode", "autotune_times", "STRATEGIES",
           "FALLBACK_CHAIN",
           "block_stats", "plan_block_gspmm", "clear_block_plans",
           "plan_block_vjp", "block_bwd_supports", "BLOCK_BWD_STRATEGIES",
           "HETERO_STRATEGIES", "plan_hetero", "clear_hetero_plans",
           "SDDMM_STRATEGIES", "sddmm_supports", "plan_sddmm",
           "clear_sddmm_plans", "ATTN_STRATEGIES", "plan_attention",
           "SERVE_MODES", "plan_serve", "clear_serve_plans",
           "drift_report", "plan_events", "RingContext", "active_ring",
           "use_ring"]

STRATEGIES = ("push", "segment", "ell", "onehot", "kernel", "ring")

# Soft-fallback order for unsupported specs: most specialized first
# (repro/core/planner.py:70, "pallas" there).
FALLBACK_CHAIN = ("kernel", "onehot", "ell", "segment")

# A pinned ring without partitioning degrades to its single-device
# analogue, the blocked pull (repro/core/planner.py:74).
_RING_FALLBACK = ("ell", "segment")

# Strategies auto considers (push is the pinned baseline only; ring only
# inside an active use_ring() context) — repro/core/planner.py:78.
_AUTO_CANDIDATES = ("ring", "kernel", "onehot", "ell", "segment")

_DEFAULT_ELL_CAP = 64
_DEFAULT_TILE_GEOM = (128, 128, 256)  # (bm, bk, eb) — build_tiles defaults


def device_of(t: Optional[torch.Tensor]) -> str:
    """The cost row of tensor ``t``: ``"cuda"`` on the card, else
    ``"cpu"``."""
    return "cuda" if t is not None and t.device.type == "cuda" else "cpu"


def dtype_name(dtype) -> Optional[str]:
    """A dtype as the JAX package names it ("float32", "bfloat16")."""
    return None if dtype is None else str(dtype).replace("torch.", "")


# --------------------------------------------------------------------- #
# graph statistics (repro/core/planner.py:96-170)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Static, hashable summary of a graph — the planner's features."""
    n_src: int
    n_dst: int
    n_edges: int
    avg_in_deg: float
    max_in_deg: int
    skew: float               # max_in_deg / avg_in_deg
    ell_padded_slots: int     # total (row, slot) cells of the bucketed ELL
    ell_n_classes: int        # number of distinct power-of-two widths
    pad_ratio: float          # ell_padded_slots / n_edges
    # row-complete ragged ELL (build_ell_ragged); the defaults keep
    # hand-built stats (tests, block_stats) valid
    ragged_padded_slots: int = 0
    ragged_n_classes: int = 0
    ragged_pad_ratio: float = 1.0


def _ell_padding(deg: np.ndarray, cap: int) -> Tuple[int, int]:
    """Padded-slot count + class count of the degree-bucketed ELL,
    estimated from the in-degree histogram without building the pack."""
    deg = deg[deg > 0]
    if deg.size == 0:
        return 0, 0
    full, rem = np.divmod(deg, cap)
    padded = int(full.sum()) * cap
    widths = set()
    rem = rem[rem > 0]
    if rem.size:
        w = np.where(rem > 1,
                     (2 ** np.ceil(np.log2(rem))).astype(np.int64),
                     np.int64(1))
        padded += int(w.sum())
        widths.update(int(x) for x in np.unique(w))
    if full.any():
        widths.add(cap)
    return padded, len(widths)


def ell_rowcomplete_padding(deg) -> Tuple[int, int]:
    """Padded-slot + class count of the ROW-COMPLETE ragged ELL
    (``build_ell_ragged``): every nonzero row padded to the next power of
    two of its own in-degree, no splitting — the attention cost row's
    slot count."""
    deg = np.asarray(deg, dtype=np.int64)
    deg = deg[deg > 0]
    if deg.size == 0:
        return 0, 0
    w = np.where(deg > 1,
                 (2 ** np.ceil(np.log2(deg))).astype(np.int64),
                 np.int64(1))
    return int(w.sum()), int(np.unique(w).size)


def compute_stats(g, ell_cap: int = _DEFAULT_ELL_CAP) -> GraphStats:
    """Host-side stats of graph ``g`` (its numpy in-degrees)."""
    deg = np.asarray(g.host.in_degrees, dtype=np.int64)
    n_edges = int(g.n_edges)
    avg = n_edges / max(g.n_dst, 1)
    mx = int(deg.max()) if deg.size else 0
    padded, n_cls = _ell_padding(deg, ell_cap)
    rslots, rcls = ell_rowcomplete_padding(deg)
    return GraphStats(
        n_src=int(g.n_src), n_dst=int(g.n_dst), n_edges=n_edges,
        avg_in_deg=float(avg), max_in_deg=mx,
        skew=float(mx / max(avg, 1e-9)),
        ell_padded_slots=int(padded), ell_n_classes=int(n_cls),
        pad_ratio=float(padded / max(n_edges, 1)),
        ragged_padded_slots=int(rslots), ragged_n_classes=int(rcls),
        ragged_pad_ratio=float(rslots / max(n_edges, 1)))


# --------------------------------------------------------------------- #
# the per-graph pack cache (repro/core/planner.py:176-418)
# --------------------------------------------------------------------- #
_PACK_BUILDS: Counter = Counter()


def pack_build_totals() -> Dict[str, int]:
    """How many packs of each kind were built (not reused) so far."""
    return dict(_PACK_BUILDS)


def _ell_pack_slots(pack: ELLPack) -> int:
    """Total padded (chunk, slot) cells of a built ELL pack."""
    return sum(int(c.chunk_mask.shape[0]) * int(c.width)
               for c in pack.classes)


def _built(kind: str, pack, slots: Optional[int] = None, n_edges: int = 0):
    """Count one pack build (``planner.pack_builds.<kind>``) and, with
    ``slots``, set the ``planner.pad_ratio.<kind>`` gauge: padded slots
    per real edge of the newest pack of that kind."""
    _PACK_BUILDS[kind] += 1
    _obs_metrics.counter(f"planner.pack_builds.{kind}").inc()
    if slots is not None:
        _obs_metrics.gauge(f"planner.pad_ratio.{kind}").set(
            slots / max(int(n_edges), 1))
    return pack


class PlanCache:
    """The stats, packs and autotuned decisions of one graph.

    ``ell(cap)``, ``tiles(bm, bk, eb)``, ``ell_uniform(width)`` and
    ``ell_ragged()`` build from the graph's host index and upload once;
    :meth:`peek` returns a default-geometry pack only if it was built.
    The graph is held weakly, as in JAX: a cache never keeps its graph
    alive."""

    def __init__(self, graph, ell_cap: int = _DEFAULT_ELL_CAP):
        self._gref = weakref.ref(graph)
        self.ell_cap = int(ell_cap)
        self.stats = compute_stats(graph, self.ell_cap)
        self._ell: Optional[ELLPack] = None
        self._tiles: Optional[TilePack] = None
        self._ragged: Optional[ELLPack] = None
        self._ell_by_cap: Dict[int, ELLPack] = {}
        self._tiles_by_geom: Dict[Tuple[int, int, int], TilePack] = {}
        self._uniform: Dict[int, ELLClass] = {}
        self._autotuned: Dict[Tuple, str] = {}
        self._partitions: Dict[Tuple[int, str], Any] = {}
        # plan_gspmm's cost-model decisions: (chosen, reason, predicted)
        self._plans: Dict[Tuple, Tuple[str, str, float]] = {}

    def _graph(self):
        g = self._gref()
        if g is None:
            raise ReferenceError("the PlanCache's graph is gone")
        return g

    def peek(self, kind: str):
        """The built default pack of ``kind`` ('ell' | 'tiles' |
        'ell_ragged'), or None; never builds."""
        return {"ell": self._ell, "tiles": self._tiles,
                "ell_ragged": self._ragged}[kind]

    def set_ell_cap(self, cap: int) -> None:
        """Change the default ELL width cap. A pack built at the old cap
        moves to the keyed memo, one built earlier at the new cap (if
        any) becomes the default, and the padding stats are recomputed,
        so the cost model describes the cap in use."""
        cap = int(cap)
        if cap == self.ell_cap:
            return
        if self._ell is not None:
            self._ell_by_cap[self.ell_cap] = self._ell
        self._ell = self._ell_by_cap.pop(cap, None)
        self.ell_cap = cap
        self.stats = compute_stats(self._graph(), cap)
        self._plans.clear()

    def ell(self, width_cap: Optional[int] = None) -> ELLPack:
        cap = self.ell_cap if width_cap is None else int(width_cap)
        if cap == self.ell_cap:
            if self._ell is None:
                self._ell = self._build_ell(cap)
            return self._ell
        if cap not in self._ell_by_cap:
            self._ell_by_cap[cap] = self._build_ell(cap)
        return self._ell_by_cap[cap]

    def _build_ell(self, cap: int) -> ELLPack:
        g = self._graph()
        pack = build_ell(g, cap)
        return _built("ell", pack, _ell_pack_slots(pack), g.n_edges)

    def tiles(self, bm: int = 128, bk: int = 128, eb: int = 256) -> TilePack:
        geom = (int(bm), int(bk), int(eb))
        if geom == _DEFAULT_TILE_GEOM:
            if self._tiles is None:
                self._tiles = _built("tiles",
                                     build_tiles(self._graph(), *geom))
            return self._tiles
        if geom not in self._tiles_by_geom:
            self._tiles_by_geom[geom] = _built(
                "tiles", build_tiles(self._graph(), *geom))
        return self._tiles_by_geom[geom]

    def ell_uniform(self, width: int) -> ELLClass:
        if width not in self._uniform:
            g = self._graph()
            cls = build_ell_uniform(g, width)
            self._uniform[width] = _built(
                "ell_uniform", cls,
                int(cls.chunk_mask.shape[0]) * int(cls.width), g.n_edges)
        return self._uniform[width]

    def ell_ragged(self) -> ELLPack:
        """Row-complete ragged ELL (``build_ell_ragged``): the fused
        attention's backward reads it (``core/edge_softmax.py``)."""
        if self._ragged is None:
            g = self._graph()
            pack = build_ell_ragged(g)
            self._ragged = _built("ell_ragged", pack, _ell_pack_slots(pack),
                                  g.n_edges)
        return self._ragged

    def partition(self, n_shards: int, mode: str = "contiguous"):
        """Memoized :class:`~repro_torch.core.partition.PartitionedGraph`
        for ``(n_shards, mode)``: the ring's pack, built on the host once
        per graph and configuration and shared by ``gspmm``'s ring route,
        the partitioned bundles and the benchmarks (its stage graphs are
        kept on it). Sets the ``planner.pad_ratio.partition`` (S²·eb
        slots) and ``partition_ragged`` (the ragged schedule's) gauges."""
        key = (int(n_shards), mode)
        if key not in self._partitions:
            from .partition import build_partition  # partition is heavy

            g = self._graph()
            pg = build_partition(g, *key)
            st = pg.stats
            self._partitions[key] = _built(
                "partition", pg, st.n_shards * st.n_shards * st.eb,
                st.n_edges)
            _obs_metrics.gauge("planner.pad_ratio.partition_ragged").set(
                st.ragged_slots / max(st.n_edges, 1))
        return self._partitions[key]

    def peek_partition(self, n_shards: int, mode: str = "contiguous"):
        """The built partition for ``(n_shards, mode)``, or None."""
        return self._partitions.get((int(n_shards), mode))

    def prefers_ell(self, d: int, device: str = "cpu") -> bool:
        """Does the cost model rank the blocked pull above every other
        route auto would take at width ``d``: segment, and the kernel
        (which on the CPU's row never wins, so there this is JAX's
        ell-versus-segment test)?"""
        ell = estimate_cost("ell", self.stats, d, device)
        return all(ell < estimate_cost(s, self.stats, d, device)
                   for s in ("segment", "kernel"))


_CACHES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_CACHES_LOCK = threading.Lock()


def get_plan_cache(g) -> PlanCache:
    """The process-wide :class:`PlanCache` of graph ``g``, made once (its
    stats with it) and kept for as long as ``g`` lives."""
    cache = _CACHES.get(g)
    if cache is None:
        with _CACHES_LOCK:
            cache = _CACHES.get(g)
            if cache is None:
                cache = _CACHES[g] = PlanCache(g)
    return cache


# --------------------------------------------------------------------- #
# cost model (repro/core/planner.py:424-528)
# --------------------------------------------------------------------- #
# Relative cost per effective element-op (lower = faster), segment = 1.
# "cpu" and "cpu:bf16" are JAX's rows (repro/core/planner.py:429-443),
# copied exactly, with JAX's "pallas" entry under "kernel": auto on the
# CPU never picks the kernel route, whose CPU form is its plain version,
# just as JAX on the CPU never picks Pallas. "cuda" was fitted on an
# NVIDIA H100 80GB HBM3 at 700 W from device-only times of each gspmm
# route at reddit-like d = 16 / 32 / 602 (benchmarks/torch_planner_fit.py;
# the fit and its inputs are in PERF.md §5). "cuda:bf16" was fitted the
# same way on bf16 features (the weight fp32, as in a bf16 training step;
# benchmarks/torch_planner_fit.py --dtype bf16, PERF.md §5),
# each route's time per element-op over the fp32 segment route's, so it
# is in the cuda row's unit, as JAX's cpu:bf16 is in cpu's, and the
# per-call costs below apply to both. "ring" on the card is the emulated
# ring's device time per bucket slot on the kernels (every stage of a pass
# on one card, B1 per stage, reddit-like at S = 4), which estimate_cost
# charges per device (slots / S); its exchange term is JAX's model
# constant, unmeasured until a multi-card ring exists.
_THROUGHPUT = {
    "cpu": {"push": 6.0, "segment": 1.0, "ell": 0.35,
            "onehot": 64.0, "kernel": 512.0, "ring": 0.5},
    "cpu:bf16": {"push": 5.5, "segment": 0.85, "ell": 0.22,
                 "onehot": 64.0, "kernel": 512.0, "ring": 0.35},
    "cuda": {"push": 0.706, "segment": 1.0, "ell": 0.985,
             "onehot": 67.5, "kernel": 0.0498, "ring": 0.238},
    "cuda:bf16": {"push": 0.734, "segment": 1.03, "ell": 1.03,
                  "onehot": 67.8, "kernel": 0.0491,
                  "ring": 0.262},
}
# Fixed per-call costs, in element-ops of the row's own unit, per device.
# "cpu": JAX's _FIXED (repro/core/planner.py:445-447) and its other
# constants (:447 per-ELL-class, :1097/:1099 hetero, :1351 attention);
# the terms JAX does not have (segment's, in the sddmm and attention
# rows) are 0 there, so the CPU's costs are JAX's to the last bit.
# "cuda": the host time of one call of each route on a small graph
# (tiny, 2,959 edges), over segment's device time per element-op at
# reddit-like (4.59e-8 ms): segment 0.095 ms, push 0.080, onehot 0.393,
# the kernel 0.062, ELL 0.951 over its 7 degree classes (charged per
# class), a ring pass at S = 4 0.356 ms. A relation of the
# hetero loop and the fused stream's setup cost one segment call, the
# attention kernel one kernel call.
_FIXED = {
    "cpu": {"push": 0.0, "segment": 0.0, "ell": 2e4,
            "onehot": 5e4, "kernel": 5e4, "ring": 1e5},
    "cuda": {"push": 1.75e6, "segment": 2.07e6, "ell": 0.0,
             "onehot": 8.56e6, "kernel": 1.34e6, "ring": 7.75e6},
}
_OVERHEAD = {
    "cpu": {"ell_class": 1.5e3, "hetero_rel": 2e4, "hetero_fixed": 2e4,
            "attn_kernel": 5e4},
    "cuda": {"ell_class": 2.96e6, "hetero_rel": 2.07e6,
             "hetero_fixed": 2.07e6, "attn_kernel": 1.34e6},
}
_TILE_EDGE_BUDGET = 256         # eb — edge slots per tile bucket
# the ring's exchange: JAX's model constant per fp32-equivalent element
# moved per stage (repro/core/planner.py:449) on every row — no
# multi-card ring has measured it — and the nominal S without a context
_RING_COMM = 0.3
_RING_DEFAULT_SHARDS = 8


def _row(device: str) -> str:
    return device if device in _FIXED else "cpu"


def _throughput_row(device: str, dtype=None) -> Dict[str, float]:
    """Device throughput row, refined by element dtype where a
    half-precision row exists (``"<device>:bf16"``, else ``cpu:bf16``)."""
    if dtype_name(dtype) == "bfloat16":
        return _THROUGHPUT.get(f"{device}:bf16", _THROUGHPUT["cpu:bf16"])
    return _THROUGHPUT[_row(device)]


def estimate_cost(strategy: str, stats: GraphStats, d: int,
                  device: str = "cpu", dtype=None, ring_stats=None,
                  comm: Optional[str] = None) -> float:
    """Estimated cost of one gspmm call on ``device`` ('cpu' | 'cuda'),
    in element-ops of that device's row. ``dtype`` (operand element type,
    default fp32) selects the per-precision row and sizes the ring's
    exchange in bytes.

    ``ring``: per-device slot work plus the per-stage exchange
    (repro/core/planner.py:487-530). ``ring_stats`` (a
    ``PartitionStats``) gives the real ragged slots and stages; without
    it the work is the ideal balance over the active context's (or a
    nominal 8) shards. ``comm`` ("none" / "int8", default the active
    context's) prices the exchange at the payload that moves."""
    tp = _throughput_row(device, dtype)[strategy]
    fixed = _FIXED[_row(device)]
    dd = max(int(d), 1)
    if strategy == "ring":
        return _ring_cost(tp, stats, dd, dtype, ring_stats, comm) + fixed[
            "ring"]
    if strategy in ("push", "segment"):
        work = stats.n_edges * dd
    elif strategy == "ell":
        work = stats.ell_padded_slots * dd
    else:  # onehot / kernel: padded tile-bucket slots (lower bound on T)
        n_buckets = max(1, -(-stats.n_edges // _TILE_EDGE_BUDGET))
        work = n_buckets * _TILE_EDGE_BUDGET * dd
    cost = tp * work + fixed[strategy]
    if strategy == "ell":
        cost += _OVERHEAD[_row(device)]["ell_class"] * stats.ell_n_classes
    return cost


def _ring_cost(tp: float, stats: GraphStats, dd: int, dtype, ring_stats,
               comm: Optional[str]) -> float:
    """The ring term of :func:`estimate_cost` without its fixed cost."""
    ctx = active_ring()
    if ring_stats is not None:
        S = ring_stats.n_shards
        rows = ring_stats.rows_per_shard
        # ragged per-diagonal widths (S · Σ_s w_s) when known, else the
        # dense S²·eb envelope
        slots = ring_stats.ragged_slots
        if slots <= 0:
            slots = S * S * ring_stats.eb
        work = (slots / S) * dd
        stages = ring_stats.ragged_stages
        if stages < 0:
            stages = S - 1
    else:
        S = ctx.n_shards if ctx is not None else _RING_DEFAULT_SHARDS
        rows = -(-max(stats.n_dst, 1) // S)
        work = (stats.n_edges / S) * dd          # ideal balance
        stages = S - 1
    if comm is None:
        comm = ctx.comm if ctx is not None else "none"
    itemsize = {"bfloat16": 2, "float16": 2, "float64": 8}.get(
        dtype_name(dtype), 4)
    _, wire = _wire_bytes(rows * dd, itemsize, comm)
    # _RING_COMM is per fp32-equivalent element, and only non-empty
    # stages are exchanged
    return tp * work + _RING_COMM * stages * (wire / 4.0)


# --------------------------------------------------------------------- #
# ring (partitioned) execution context (repro/core/planner.py:535-571)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RingContext:
    """An installed process group makes ``ring`` a planner candidate.

    ``mesh`` is the ``torch.distributed`` process group the shards live
    on (JAX's mesh; ``axis`` names its ring axis, kept for JAX's
    signature); ``comm`` declares the wire mode ("none" / "int8") the
    cost model prices the exchange at."""
    mesh: Any
    axis: str = "data"
    mode: str = "contiguous"
    comm: str = "none"

    @property
    def n_shards(self) -> int:
        import torch.distributed as dist

        return int(dist.get_world_size(self.mesh))


_RING_CTX: Optional[RingContext] = None


def active_ring() -> Optional[RingContext]:
    """The :func:`use_ring` context in force, or None (no process group
    given: the ring never qualifies)."""
    return _RING_CTX


@contextlib.contextmanager
def use_ring(mesh, axis: str = "data", mode: str = "contiguous",
             comm: str = "none"):
    """Enable partitioned (ring) execution for ``gspmm`` while active,
    over the ``torch.distributed`` process group ``mesh``. With
    ``mesh=None`` (one card) nothing is enabled: ``strategy="auto"``
    plans single-device and a pinned ``"ring"`` falls back down the
    established chain."""
    global _RING_CTX
    prev = _RING_CTX
    _RING_CTX = (None if mesh is None else
                 RingContext(mesh=mesh, axis=axis, mode=mode, comm=comm))
    try:
        yield _RING_CTX
    finally:
        _RING_CTX = prev


def _ring_ready(stats: GraphStats) -> bool:
    """Can the ring run here: a live context and one shared vertex space
    (JAX's ``pack_available``; the partition builds on the host)."""
    return active_ring() is not None and stats.n_src == stats.n_dst


def _ring_stats(cache: "PlanCache"):
    """The built partition's stats for the active context, or None."""
    ctx = active_ring()
    if ctx is None:
        return None
    pg = cache.peek_partition(ctx.n_shards, ctx.mode)
    return None if pg is None else pg.stats


# --------------------------------------------------------------------- #
# spec support predicates (repro/core/planner.py:580-628)
# --------------------------------------------------------------------- #
def supports(strategy: str, spec, lhs_data, rhs_data) -> bool:
    """Can ``strategy`` execute this node-output spec at all?

    ``"kernel"`` is JAX's ``"pallas"`` predicate on fp32 operands:
    :func:`~repro_torch.kernels.dispatch.kernel_supports` (B1 / B4). Edge
    outputs are planned by :func:`plan_sddmm`.
    """
    red = spec.reduce
    if strategy in ("push", "segment"):
        return spec.out in ("u", "v") and red != "none"
    if spec.out != "v" or red == "none":
        return False
    if strategy == "ring":
        # sharded weighted CR: source-node lhs, sum / mean, rank 2, plain
        # copy or a scalar edge weight (mean folds 1/deg into it)
        if red not in ("sum", "mean") or spec.lhs != "u":
            return False
        if lhs_data.ndim != 2:
            return False
        if spec.op == "copy":
            return True
        return (spec.op == "mul" and spec.rhs == "e"
                and rhs_data.ndim == 2 and rhs_data.shape[-1] == 1)
    if strategy == "ell":
        return True     # any ⊗, any operand targets, all reducers
    if strategy == "kernel":
        return kernel_supports(spec, lhs_data, rhs_data)
    if strategy == "onehot":
        rank_ok = (lhs_data.ndim == 2
                   and (rhs_data is None or rhs_data.ndim == 2))
        if not rank_ok or red not in ("sum", "mean") or spec.lhs != "u":
            return False
        if spec.op == "copy":
            return True
        return (spec.op == "mul" and spec.rhs == "e"
                and rhs_data.shape[-1] == 1)
    raise ValueError(f"unknown strategy {strategy!r}")


# --------------------------------------------------------------------- #
# plan log + fallback warnings (repro/core/planner.py:634-670)
# --------------------------------------------------------------------- #
_PLAN_LOG: Dict[Tuple[str, str], Counter] = {}
_LAST_PLAN: Dict[Tuple[str, str], str] = {}
_WARNED: set = set()


def _record(spec_name: str, requested: str, chosen: str,
            predicted: Optional[float] = None,
            dtype: Optional[str] = None) -> None:
    key = (spec_name, requested)
    _PLAN_LOG.setdefault(key, Counter())[chosen] += 1
    _LAST_PLAN[key] = chosen
    _obs_events.plan_event(spec_name, requested, chosen,
                           predicted_cost=predicted, dtype=dtype)


def plan_log() -> Dict[Tuple[str, str], Dict[str, int]]:
    """(op name, requested strategy) -> {chosen strategy: count}."""
    return {k: dict(v) for k, v in _PLAN_LOG.items()}


def clear_plan_log() -> None:
    _PLAN_LOG.clear()
    _LAST_PLAN.clear()


def last_plan(spec_name: str, requested: str = "auto") -> Optional[str]:
    """Most-recently chosen strategy for (op, requested), or None."""
    return _LAST_PLAN.get((spec_name, requested))


def _warn_fallback(spec_name: str, requested: str, chosen: str) -> None:
    key = (spec_name, requested)
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(f"strategy {requested!r} does not support {spec_name!r}"
                  f"; falling back to {chosen!r}", stacklevel=3)


# --------------------------------------------------------------------- #
# planner mode (cost model vs measure-and-cache autotune)
# --------------------------------------------------------------------- #
_MODE = os.environ.get("REPRO_PLANNER_MODE", "cost")


def set_mode(mode: str) -> None:
    """'cost' (default) or 'autotune' (measure candidates once, cache)."""
    global _MODE
    if mode not in ("cost", "autotune"):
        raise ValueError(f"unknown planner mode {mode!r}")
    _MODE = mode


def get_mode() -> str:
    return _MODE


def _measure(runner: Callable[[str], Any], strategy: str) -> tuple:
    """``(wall, device)``: seconds of one call of ``runner(strategy)``
    after one warm-up, fenced (``torch.cuda.synchronize``) where its
    output is on the card, and that call's device seconds between two
    CUDA timing events (None where its output is on the host)."""
    fence(runner(strategy))
    marks = None
    if torch.cuda.is_initialized():
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        marks[0].record()
    t0 = time.perf_counter()
    out = runner(strategy)
    if marks is not None:
        marks[1].record()
    fence(out)
    wall = time.perf_counter() - t0
    on_card = marks is not None and _cuda_devices(out, set())
    return wall, marks[0].elapsed_time(marks[1]) / 1e3 if on_card else None


_AUTOTUNE_TIMES: Dict[str, Dict[str, float]] = {}


def _autotune(log_name: str, runner, candidates) -> str:
    """The candidate of least wall time; its measured row is the device
    time where it ran on the card, as ``obs.events.timed`` records."""
    got = {s: _measure(runner, s) for s in candidates}
    times = {s: wall for s, (wall, _) in got.items()}
    winner = min(times, key=times.get)
    _AUTOTUNE_TIMES[log_name] = times
    wall, device = got[winner]
    _obs_events.measured_event(log_name, wall if device is None else device)
    return winner


def autotune_times(op: str) -> Optional[Dict[str, float]]:
    """Seconds per candidate of the latest autotune measurement of plan
    row ``op`` (``"u_copy_add_v"``, ``"block:<op>"``, ...), or None."""
    return _AUTOTUNE_TIMES.get(op)


# --------------------------------------------------------------------- #
# the planner (repro/core/planner.py:701-847)
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class Plan:
    """Resolved execution plan for one gspmm call."""
    strategy: str
    requested: str
    reason: str                     # 'pinned' | 'cost' | 'autotune' | ...


def plan_gspmm(g, spec, lhs_data, rhs_data, *, requested: str = "auto",
               cache: Optional[PlanCache] = None,
               runner: Optional[Callable[[str], Any]] = None,
               device: Optional[str] = None) -> Plan:
    """Pick the execution strategy for one node-output BR.

    ``requested='auto'`` consults the cost model (or the autotune cache)
    with the row of ``lhs_data``'s device (``device`` overrides it: what
    the card would choose, asked on the host); a pinned strategy is
    honored when it supports the spec and falls back down
    :data:`FALLBACK_CHAIN` otherwise. ``runner`` (optional) executes the
    call with a pinned strategy — autotune mode measures candidates with
    it.
    """
    if cache is None:
        cache = get_plan_cache(g)
    device = device or device_of(lhs_data)
    dtype = dtype_name(lhs_data.dtype)
    # a decision depends on the spec, the operands' trailing shapes and
    # dtypes and the device alone: the cost model's is made once per
    # graph and key (PyTorch plans every eager call; JAX once per trace)
    ctx = active_ring()
    key = (spec.name, requested, device, tuple(lhs_data.shape[1:]), dtype,
           None if rhs_data is None
           else (tuple(rhs_data.shape[1:]), dtype_name(rhs_data.dtype)),
           None if ctx is None else (ctx.n_shards, ctx.mode, ctx.comm))
    hit = cache._plans.get(key)
    if hit is None or (requested == "auto" and _MODE == "autotune"):
        hit = _decide(spec, lhs_data, rhs_data, requested, cache, runner,
                      device)
        if hit[1] != "autotune":
            cache._plans[key] = hit
    chosen, reason, predicted = hit
    if reason.startswith("fallback"):
        _warn_fallback(spec.name, requested, chosen)
    _record(spec.name, requested, chosen,
            predicted if _obs_events.enabled() else None, dtype=dtype)
    return Plan(strategy=chosen, requested=requested, reason=reason)


def _decide(spec, lhs_data, rhs_data, requested, cache, runner,
            device) -> Tuple[str, str, float]:
    """(chosen, reason, predicted cost of chosen) of one gspmm plan."""
    stats = cache.stats

    def ok(strategy: str) -> bool:
        return (supports(strategy, spec, lhs_data, rhs_data)
                and (strategy != "ring" or _ring_ready(stats)))

    if requested == "auto":
        chosen, reason = _plan_auto(spec, lhs_data, rhs_data, stats, ok,
                                    cache, runner, device)
    else:
        if requested not in STRATEGIES:
            raise ValueError(f"unknown strategy {requested!r}; expected "
                             f"one of {STRATEGIES + ('auto',)}")
        if ok(requested):
            chosen, reason = requested, "pinned"
        else:
            if requested == "ring":
                chain = _RING_FALLBACK
            elif requested in FALLBACK_CHAIN:
                chain = FALLBACK_CHAIN[FALLBACK_CHAIN.index(requested) + 1:]
            else:
                chain = ("segment",)
            chosen = next((s for s in chain if ok(s)), "segment")
            reason = f"fallback({requested})"
    predicted = estimate_cost(chosen, stats, _width(lhs_data), device,
                              lhs_data.dtype, ring_stats=_ring_stats(cache))
    return chosen, reason, predicted


def _width(x) -> int:
    return int(np.prod(x.shape[1:])) if x.ndim > 1 else 1


def _plan_auto(spec, lhs_data, rhs_data, stats, ok, cache, runner,
               device) -> Tuple[str, str]:
    d = _width(lhs_data)
    candidates = [s for s in _AUTO_CANDIDATES if ok(s)]
    if not candidates:           # out == 'u' etc. → segment path
        return "segment", "only-generic"
    if _MODE == "autotune" and runner is not None:
        # the device and the ring context are part of the key: a winner
        # measured on one device, or inside use_ring(), is never replayed
        # elsewhere
        ctx = active_ring()
        key = (spec.name, d, dtype_name(lhs_data.dtype),
               None if rhs_data is None else rhs_data.shape[-1], device,
               None if ctx is None else (ctx.n_shards, ctx.axis, ctx.mode))
        winner = cache._autotuned.get(key)
        if winner is None or winner not in candidates:
            winner = _autotune(spec.name, runner, candidates)
            cache._autotuned[key] = winner
        return winner, "autotune"
    ring_stats = _ring_stats(cache)
    chosen = min(candidates, key=lambda s: estimate_cost(
        s, stats, d, device, lhs_data.dtype, ring_stats=ring_stats))
    return chosen, "cost"


# --------------------------------------------------------------------- #
# block (sampled-minibatch) planning — shape-keyed
# (repro/core/planner.py:853-955)
# --------------------------------------------------------------------- #
# Sampled blocks are padded to static shapes, so their planner features
# depend only on the shape signature (n_src_pad, n_dst_real, n_edges_pad,
# fanout). Decisions are memoized on that signature (plus op, width,
# device, dtype and whether the kernel takes the operands), so planning
# is deterministic across batches.
_BLOCK_PLANS: Dict[Tuple, str] = {}

# Candidates of auto on blocks. The uniform pull reuses the 'ell' cost
# entry (it IS a single-class ELL); onehot needs a host-built tile pack
# per graph, so it never qualifies. The port adds its kernel route (B1 /
# B4 on the padded block graph), which needs no pack.
_BLOCK_AUTO_CANDIDATES = ("ell", "segment", "kernel")
_BLOCK_FALLBACK = ("ell", "segment")


def block_stats(n_src: int, n_dst_real: int, n_edges: int,
                fanout: int) -> GraphStats:
    """Nominal :class:`GraphStats` of a padded block: a uniform
    single-class ELL by construction (max degree == avg degree ==
    fanout, ``n_dst_real * fanout`` padded slots)."""
    slots = n_dst_real * fanout
    return GraphStats(
        n_src=int(n_src), n_dst=int(n_dst_real), n_edges=int(n_edges),
        avg_in_deg=float(fanout), max_in_deg=int(fanout), skew=1.0,
        ell_padded_slots=int(slots), ell_n_classes=1,
        pad_ratio=float(slots / max(n_edges, 1)))


def clear_block_plans() -> None:
    _BLOCK_PLANS.clear()
    _BLOCK_BWD_PLANS.clear()


def plan_block_gspmm(signature: Tuple[int, int, int, int], spec, d: int,
                     requested: str = "auto",
                     runner: Optional[Callable[[str], Any]] = None,
                     dtype: Optional[str] = None, device: str = "cpu",
                     kernel_ok: bool = False) -> str:
    """Pick the execution strategy for one block aggregation.

    ``signature`` is :attr:`BlockGraph.signature`; ``kernel_ok`` says
    whether the kernel route takes the operands
    (:func:`~repro_torch.kernels.dispatch.kernel_supports`). The choice
    is memoized per (signature, op, width, requested, device, dtype,
    kernel_ok) and logged as ``block:<op>``. A pinned name no block route
    runs (``onehot``, ``pallas``, ``ring``, or ``kernel`` on operands it
    does not take) falls back to ``ell`` with a one-time warning, as in
    JAX. In autotune mode ``runner`` measures the candidates once per
    key.
    """
    from .blocks import block_supports  # local: blocks imports planner

    dtype = dtype_name(dtype)
    key = (tuple(signature), spec.name, int(d), requested, device, dtype,
           bool(kernel_ok))
    log_name = f"block:{spec.name}"

    def ok(s):
        return block_supports(s, spec) and (s != "kernel" or kernel_ok)

    chosen = _BLOCK_PLANS.get(key)
    if chosen is None:
        memoize = True
        if requested == "auto":
            candidates = [s for s in _BLOCK_AUTO_CANDIDATES if ok(s)]
            if not candidates:
                chosen = "segment"
            elif _MODE == "autotune" and runner is not None:
                chosen = _autotune(log_name, runner, candidates)
            else:
                stats = block_stats(*signature)
                chosen = min(candidates, key=lambda s: estimate_cost(
                    s, stats, d, device, dtype))
                # a cost stand-in made in autotune mode is not pinned,
                # so a later call with a runner still gets to measure
                memoize = _MODE != "autotune"
        elif requested not in STRATEGIES + ("pallas",):
            raise ValueError(f"unknown strategy {requested!r}; expected "
                             f"one of {STRATEGIES + ('auto',)}")
        elif ok(requested):
            chosen = requested
        else:
            chosen = next((s for s in _BLOCK_FALLBACK if ok(s)), "segment")
        if memoize:
            _BLOCK_PLANS[key] = chosen
    if requested not in ("auto", chosen):
        _warn_fallback(log_name, requested, chosen)
    predicted = None
    if _obs_events.enabled():
        predicted = estimate_cost(chosen, block_stats(*signature), d,
                                  device, dtype)
    _record(log_name, requested, chosen, predicted, dtype=dtype)
    return chosen


# --------------------------------------------------------------------- #
# block BACKWARD planning (repro/core/planner.py:972-1077)
# --------------------------------------------------------------------- #
# 'gather' is the reverse-table VJP (core/blocks.py): cotangents pulled
# over the block's Gᵀ + one sorted segment reduce ('scatter' is autograd
# of the forward). After a kernel forward the gather backward runs on the
# kernels too (B1 / B3 / B4 over the block's G and Gᵀ), which JAX's rows,
# pricing a plain pull against autodiff, do not describe: auto takes it
# there. A plain block's kernel forward has no scatter backward at all.
BLOCK_BWD_STRATEGIES = ("gather", "scatter")

_BLOCK_BWD_PLANS: Dict[Tuple, str] = {}

# JAX's collision / row-density term: a scatter-add only serializes
# where updates collide, scaled by the block's row density and by how
# much of the full-serialization edge-slot scale it reaches; the gather
# pays its reorder tax unconditionally.
_BWD_COLLISION_SLOTS = 1_000_000   # full-serialization edge-slot scale
_BWD_GATHER_REORDER = 0.45         # gather's extra work vs one segment pass


def _block_bwd_cost(strategy: str, signature: Tuple[int, int, int, int],
                    d: int, device: str = "cpu") -> float:
    """Estimated cost of differentiating one block op (element-ops), on
    ``device``'s row."""
    n_src, _, slots, _ = signature
    tp = _THROUGHPUT[_row(device)]
    dd = max(int(d), 1)
    if strategy == "gather":
        return tp["segment"] * (1.0 + _BWD_GATHER_REORDER) * slots * dd
    rho = min(1.0, slots / max(n_src, 1))
    size = min(1.0, slots / _BWD_COLLISION_SLOTS)
    scatter_tp = tp["segment"] + (tp["push"] - tp["segment"]) * rho * size
    return scatter_tp * slots * dd


def block_bwd_supports(strategy: str, spec) -> bool:
    """Can ``strategy`` differentiate this block spec? 'scatter'
    (autograd) always can; 'gather' needs a node output and a sum / mean
    / max / min reducer (the extrema through the arg-extremum slot
    table). Only prod stays on autograd."""
    if strategy == "scatter":
        return True
    if strategy == "gather":
        return spec.out == "v" and spec.reduce in ("sum", "mean",
                                                   "max", "min")
    raise ValueError(f"unknown block backward strategy {strategy!r}")


def plan_block_vjp(signature: Tuple[int, int, int, int], spec, d: int,
                   requested: str = "auto", gather_available: bool = True,
                   runner: Optional[Callable[[str], Any]] = None,
                   dtype: Optional[str] = None, device: str = "cpu",
                   kernel_forward: bool = False,
                   scatter_available: bool = True) -> str:
    """Pick the backward (differentiation) strategy of one block op,
    memoized per (signature, op, width, requested, gather_available,
    kernel_forward, scatter_available, device) and logged as
    ``block_bwd:<op>``. After a kernel forward auto takes the gather.
    A pinned strategy that cannot run falls back to the other one with
    a one-time warning. In autotune mode ``runner`` measures the two
    differentiated calls once per key."""
    dtype = dtype_name(dtype)
    key = (tuple(signature), spec.name, int(d), requested,
           bool(gather_available), bool(kernel_forward),
           bool(scatter_available), device)
    log_name = f"block_bwd:{spec.name}"

    def ok(s):
        if s == "scatter":
            return scatter_available
        return block_bwd_supports(s, spec) and gather_available

    chosen = _BLOCK_BWD_PLANS.get(key)
    if chosen is None:
        memoize = True
        if requested == "auto":
            if not ok("gather"):
                chosen = "scatter"
            elif kernel_forward or not ok("scatter"):
                chosen = "gather"
            elif _MODE == "autotune" and runner is not None:
                chosen = _autotune(log_name, runner, BLOCK_BWD_STRATEGIES)
            else:
                chosen = min(BLOCK_BWD_STRATEGIES,
                             key=lambda s: _block_bwd_cost(
                                 s, signature, d, device))
                memoize = _MODE != "autotune"
        elif requested not in BLOCK_BWD_STRATEGIES:
            raise ValueError(
                f"unknown block backward strategy {requested!r}; expected "
                f"one of {BLOCK_BWD_STRATEGIES + ('auto',)}")
        elif ok(requested):
            chosen = requested
        else:
            chosen = "gather" if requested == "scatter" else "scatter"
        if memoize:
            _BLOCK_BWD_PLANS[key] = chosen
    if requested not in ("auto", chosen):
        _warn_fallback(log_name, requested, chosen)
    predicted = None
    if _obs_events.enabled():
        predicted = _block_bwd_cost(chosen, signature, d, device)
    _record(log_name, requested, chosen, predicted, dtype=dtype)
    return chosen


# --------------------------------------------------------------------- #
# heterogeneous (relation-fused) planning (repro/core/planner.py:1093-1190)
# --------------------------------------------------------------------- #
# 'loop' (R sequential aggregations), 'fused' (one sorted segment reduce
# over the relation-stacked graph), 'ell' (the fused messages through the
# fused graph's blocked pull), 'push' (the loop with a scatter, pinned
# only) and the port's 'kernel' (B1 over the relation-expanded graph,
# sum / mean on fp32 operands). Memoized per static RelGraph signature ×
# op × width × requested × device; logged as ``hetero:<op>``.
HETERO_STRATEGIES = ("fused", "loop", "ell", "kernel")

_HETERO_PLANS: Dict[Tuple, str] = {}

_HETERO_FUSED_TAX = 0.1      # relation-id/W-indexing traffic multiplier

_HETERO_FALLBACK = ("fused", "loop")


def _hetero_cost(strategy: str, signature: Tuple[int, int, int, int],
                 d: int, device: str = "cpu",
                 stats: Optional[GraphStats] = None) -> Optional[float]:
    """Estimated cost of one relational aggregation (element-ops); None
    where the strategy has no model (ell without fused stats)."""
    _, _, n_edges, n_rel = signature
    row = _row(device)
    tp, over = _THROUGHPUT[row], _OVERHEAD[row]
    dd = max(int(d), 1)
    if strategy == "loop":
        return tp["segment"] * n_edges * dd + n_rel * over["hetero_rel"]
    if strategy == "fused":
        return (tp["segment"] * (1 + _HETERO_FUSED_TAX) * n_edges * dd
                + over["hetero_fixed"])
    if strategy == "ell" and stats is not None:
        return ((1 + _HETERO_FUSED_TAX)
                * estimate_cost("ell", stats, dd, device))
    if strategy == "push":
        return tp["push"] * n_edges * dd + n_rel * over["hetero_rel"]
    if strategy == "kernel":
        return tp["kernel"] * n_edges * dd + _FIXED[row]["kernel"]
    return None


def clear_hetero_plans() -> None:
    _HETERO_PLANS.clear()


def plan_hetero(signature: Tuple[int, int, int, int], op_name: str,
                d: int, requested: str = "auto",
                stats: Optional[GraphStats] = None, ell_ok: bool = True,
                runner: Optional[Callable[[str], Any]] = None,
                device: str = "cpu", kernel_ok: bool = False) -> str:
    """Pick the execution strategy for one relational aggregation.

    ``signature`` is :attr:`RelGraph.signature`; ``stats`` the fused
    graph's :class:`GraphStats` (the ell row's padding); ``kernel_ok``
    whether the kernel route takes the call (sum / mean, fp32). A plain
    gspmm strategy name pins the per-relation loop, ``'push'`` the loop
    with a scatter, as in JAX; a pinned ``'kernel'`` (or ``'ell'``) that
    cannot run falls back to ``'fused'`` with a one-time warning.
    """
    key = (tuple(signature), op_name, int(d), requested, device,
           bool(kernel_ok))
    log_name = f"hetero:{op_name}"

    def candidates():
        cand = ["fused", "loop"]
        if ell_ok and stats is not None:
            cand.insert(1, "ell")
        if kernel_ok:
            cand.append("kernel")
        return cand

    chosen = _HETERO_PLANS.get(key)
    if chosen is None:
        memoize = True
        if requested == "auto":
            cand = candidates()
            if _MODE == "autotune" and runner is not None:
                chosen = _autotune(log_name, runner, cand)
            else:
                chosen = min(cand, key=lambda s: _hetero_cost(
                    s, signature, d, device, stats))
                memoize = _MODE != "autotune"
        elif requested in HETERO_STRATEGIES:
            chosen = requested if requested in candidates() else "fused"
        elif requested in STRATEGIES + ("pallas",):
            # plain gspmm pin: the per-relation loop with that inner
            # reduce — 'push' is the scatter baseline
            chosen = "push" if requested == "push" else "loop"
        else:
            raise ValueError(
                f"unknown hetero strategy {requested!r}; expected one "
                f"of {HETERO_STRATEGIES + STRATEGIES + ('auto',)}")
        if memoize:
            _HETERO_PLANS[key] = chosen
    if requested in HETERO_STRATEGIES and chosen != requested:
        _warn_fallback(log_name, requested, chosen)
    predicted = None
    if _obs_events.enabled():
        predicted = _hetero_cost(chosen, signature, d, device, stats)
    _record(log_name, requested, chosen, predicted)
    return chosen


# --------------------------------------------------------------------- #
# gSDDMM (edge-output) planning (repro/core/planner.py:1212-1325)
# --------------------------------------------------------------------- #
# 'gather' (operands gathered straight into caller order), 'canonical'
# (gathered in dst-sorted order, ⊗, one un-permute) and 'kernel' (B3,
# JAX's 'pallas'). Memoized per (sizes, op, width, requested, device,
# kernel support); logged as ``sddmm:<op>``.
SDDMM_STRATEGIES = ("canonical", "gather", "kernel")

_SDDMM_PLANS: Dict[Tuple, str] = {}

# JAX's relative tax between the two universal forms: canonical pays it
# on the CPU (the full-width un-permute dominates there), gather on an
# accelerator (per-operand random gathers).
_SDDMM_GATHER_TAX = 1.25

_SDDMM_FALLBACK = ("canonical", "gather")


def clear_sddmm_plans() -> None:
    _SDDMM_PLANS.clear()
    _ATTN_PLANS.clear()


def sddmm_supports(strategy: str, spec, lhs_data, rhs_data) -> bool:
    """Can ``strategy`` execute this EDGE-output spec? canonical / gather
    are universal; ``"kernel"`` is B3's predicate (rank-2 fp32 streams
    whose widths match or broadcast from 1)."""
    if spec.out != "e":
        return False
    if strategy in ("canonical", "gather"):
        return True
    if strategy == "kernel":
        return sddmm_kernel_supports(spec, lhs_data, rhs_data)
    raise ValueError(f"unknown sddmm strategy {strategy!r}")


def _sddmm_cost(strategy: str, n_edges: int, d: int,
                device: str = "cpu") -> float:
    row = _row(device)
    tp, fixed = _THROUGHPUT[row], _FIXED[row]
    work = n_edges * max(int(d), 1)
    if strategy == "canonical":
        tax = _SDDMM_GATHER_TAX if row == "cpu" else 1.0
        return tp["segment"] * tax * work + fixed["segment"]
    if strategy == "gather":
        tax = 1.0 if row == "cpu" else _SDDMM_GATHER_TAX
        return tp["segment"] * tax * work + fixed["segment"]
    return tp["kernel"] * work + fixed["kernel"]


def plan_sddmm(signature: Tuple[int, int, int], spec, d: int,
               requested: str = "auto", lhs_data=None, rhs_data=None,
               runner: Optional[Callable[[str], Any]] = None,
               device: Optional[str] = None) -> str:
    """Pick the execution strategy for one edge-output BR (gSDDMM).

    ``signature`` is ``(n_src, n_dst, n_edges)``; the operands (optional:
    their absence disqualifies the kernel) feed the support predicate and
    give the device (``device`` overrides it). A pinned ``'kernel'`` that
    cannot run falls back to ``'canonical'`` with a one-time warning.
    Logged as ``sddmm:<op>``.
    """
    device = device or device_of(lhs_data)
    kernel_ok = (lhs_data is not None
                 and sddmm_supports("kernel", spec, lhs_data, rhs_data))
    key = (tuple(signature), spec.name, int(d), requested, device,
           kernel_ok)
    log_name = f"sddmm:{spec.name}"
    chosen = _SDDMM_PLANS.get(key)
    if chosen is None:
        n_edges = signature[2]
        memoize = True
        if requested == "auto":
            cand = [s for s in SDDMM_STRATEGIES
                    if s != "kernel" or kernel_ok]
            if _MODE == "autotune" and runner is not None:
                chosen = _autotune(log_name, runner, cand)
            else:
                chosen = min(cand, key=lambda s: _sddmm_cost(
                    s, n_edges, d, device))
                memoize = _MODE != "autotune"
        elif requested not in SDDMM_STRATEGIES:
            raise ValueError(
                f"unknown sddmm strategy {requested!r}; expected one of "
                f"{SDDMM_STRATEGIES + ('auto',)}")
        elif requested != "kernel" or kernel_ok:
            chosen = requested
        else:
            chosen = _SDDMM_FALLBACK[0]
        if memoize:
            _SDDMM_PLANS[key] = chosen
    if requested not in ("auto", chosen):
        _warn_fallback(log_name, requested, chosen)
    predicted = None
    if _obs_events.enabled():
        predicted = _sddmm_cost(chosen, signature[2], d, device)
    _record(log_name, requested, chosen, predicted,
            dtype=None if lhs_data is None else dtype_name(lhs_data.dtype))
    return chosen


# --------------------------------------------------------------------- #
# fused-attention planning (repro/core/planner.py:1342-1409)
# --------------------------------------------------------------------- #
# 'fused' — the canonical single-pass PyTorch form; 'kernel' — B2 (JAX's
# 'pallas' megakernel); 'ring' — the partitioned composition
# (ring_edge_values → bucket_softmax → ring_gspmm), pinned by
# core/edge_softmax.fused_attention_partitioned.
# Logged under ONE name, ``attn:fused``.
ATTN_STRATEGIES = ("fused", "kernel", "ring")

_ATTN_PLANS: Dict[Tuple, str] = {}


def _attn_cost(strategy: str, n_edges: int, hf: int, device: str = "cpu",
               padded_slots: Optional[int] = None) -> Optional[float]:
    """Estimated cost of one fused-attention pass (element-ops); None
    for ring. The kernel is priced on JAX's row-complete slot count; on
    the CPU (where it runs its plain version) at the ell rate, as JAX
    prices interpret-mode Pallas."""
    row = _row(device)
    tp = _THROUGHPUT[row]
    if strategy == "fused":
        return tp["segment"] * n_edges * hf + _FIXED[row]["segment"]
    if strategy == "kernel":
        slots = n_edges if padded_slots is None else padded_slots
        rate = tp["ell"] if row == "cpu" else tp["kernel"]
        return rate * slots * hf + _OVERHEAD[row]["attn_kernel"]
    return None


def plan_attention(signature: Tuple[int, int, int], heads: int, feat: int,
                   requested: str = "auto", kernel_ok: bool = False,
                   padded_slots: Optional[int] = None,
                   dtype: Optional[str] = None, device: str = "cpu") -> str:
    """Pick the fused-attention execution form; logged ``attn:fused``.

    ``signature`` = (n_src, n_dst, n_edges); ``kernel_ok`` — whether B2
    takes the operands; ``padded_slots`` refines the kernel's work
    estimate (the row-complete ragged pack's slot count). A pinned
    ``'kernel'`` that cannot run falls back to ``'fused'`` with a
    one-time warning.
    """
    key = (tuple(signature), int(heads), int(feat), requested, device,
           bool(kernel_ok), padded_slots)
    chosen = _ATTN_PLANS.get(key)
    if chosen is None:
        n_edges = signature[2]
        hf = max(int(heads), 1) * max(int(feat), 1)
        if requested == "auto":
            cand = ["fused"] + (["kernel"] if kernel_ok else [])
            chosen = min(cand, key=lambda s: _attn_cost(
                s, n_edges, hf, device, padded_slots))
        elif requested not in ATTN_STRATEGIES:
            raise ValueError(
                f"unknown attention strategy {requested!r}; expected one "
                f"of {ATTN_STRATEGIES + ('auto',)}")
        elif requested == "kernel" and not kernel_ok:
            chosen = "fused"
        else:
            chosen = requested
        _ATTN_PLANS[key] = chosen
    if requested not in ("auto", chosen):
        _warn_fallback("attn:fused", requested, chosen)
    predicted = None
    if _obs_events.enabled():
        hf = max(int(heads), 1) * max(int(feat), 1)
        predicted = _attn_cost(chosen, signature[2], hf, device,
                               padded_slots)
    _record("attn:fused", requested, chosen, predicted,
            dtype=dtype_name(dtype))
    return chosen


# --------------------------------------------------------------------- #
# serving planning (repro/core/planner.py:1425-1481)
# --------------------------------------------------------------------- #
# 'layerwise' — each layer computed once for ALL nodes per refresh,
# requests answered by cached row lookups; 'fanout' — per-request L-hop
# block expansion, never stale. Logged per op as ``serve:<op>``.
SERVE_MODES = ("layerwise", "fanout")

_SERVE_PLANS: Dict[Tuple, str] = {}

# host-side gather + cache bookkeeping per served row, in the JAX
# planner's edge-work currency (relative units)
_SERVE_LOOKUP_COST = 8.0


def _serve_cost(mode: str, signature: Tuple[int, int, int, int],
                expansion_edges: int, refresh_batches: int) -> float:
    """Estimated per-batch cost of one serve mode (element-ops)."""
    n_edges, cls, layers = signature[1], signature[2], signature[3]
    if mode == "layerwise":
        per = max(int(refresh_batches), 1)
        return ((n_edges * max(layers, 1)) / per
                + _SERVE_LOOKUP_COST * cls)
    return float(expansion_edges)


def plan_serve(signature: Tuple[int, int, int, int], op_name: str = "infer",
               requested: str = "auto", *, expansion_edges: int,
               refresh_batches: int = 1024, device: str = "cpu") -> str:
    """Pick the serve-time execution mode; logged ``serve:<op_name>``.

    ``signature`` = (n_nodes, n_edges, batch_class, n_layers);
    ``expansion_edges`` is the static padded edge-slot count of ONE
    fan-out batch of this class (summed over its block signatures);
    ``refresh_batches`` amortizes the layer-wise recompute over the
    batches expected between refreshes. Ties go to ``layerwise``.
    """
    key = (tuple(signature), op_name, requested, device,
           int(expansion_edges), int(refresh_batches))
    log_name = f"serve:{op_name}"
    chosen = _SERVE_PLANS.get(key)
    if chosen is None:
        if requested == "auto":
            chosen = min(SERVE_MODES, key=lambda m: _serve_cost(
                m, signature, expansion_edges, refresh_batches))
        elif requested not in SERVE_MODES:
            raise ValueError(
                f"unknown serve mode {requested!r}; expected one of "
                f"{SERVE_MODES + ('auto',)}")
        else:
            chosen = requested
        _SERVE_PLANS[key] = chosen
    predicted = None
    if _obs_events.enabled():
        predicted = _serve_cost(chosen, signature, expansion_edges,
                                refresh_batches)
    _record(log_name, requested, chosen, predicted)
    return chosen


def clear_serve_plans() -> None:
    _SERVE_PLANS.clear()
