"""Execution planning (port of ``repro/core/planner.py``; the serve rows
and the block backward rows).

How a micro-batched inference request executes:

* ``layerwise`` — each layer computed once for ALL nodes per refresh,
  requests answered by cached row lookups: the per-batch cost is the
  refresh's edge work amortized over the refresh period plus a lookup
  per served row;
* ``fanout`` — per-request L-hop block expansion through
  ``infer_blocks``: the per-batch cost is the padded block edge work,
  but results are never stale.

:func:`plan_serve` picks the cheaper by the JAX planner's formula, with
its constants, so both packages choose the same mode for the same
configuration.

:func:`plan_block_vjp` picks how a sampled block's aggregation is
differentiated (``gather``: the reverse-table pull; ``scatter``: autograd
of the forward), memoized per shape signature. On the CPU it runs the JAX
cost model with the JAX ``cpu`` throughput row, so both packages choose
alike there; on CUDA it takes ``gather`` wherever
:func:`block_bwd_supports` allows it (the port has no measured ``cuda``
row yet). The plan log (``serve:<op>``, ``block_bwd:<op>`` rows with
predicted costs) and the kernel-strategy rows come with the rest of the
planner (ROADMAP A9).

:class:`PlanCache` is the pack half of the JAX ``PlanCache``: one per
graph (:func:`get_plan_cache`), it builds each blocked pack
(``core/tiling.py``) at most once, on the host, at first use. The graph
statistics and the cost model that read them are A9's.
"""
from __future__ import annotations

import threading
import warnings
import weakref
from collections import Counter
from typing import Dict, Optional, Set, Tuple

from .tiling import (ELLClass, ELLPack, TilePack, build_ell, build_ell_ragged,
                     build_ell_uniform, build_tiles)

__all__ = ["SERVE_MODES", "plan_serve", "BLOCK_BWD_STRATEGIES",
           "block_bwd_supports", "plan_block_vjp", "PlanCache",
           "get_plan_cache", "pack_build_totals"]

SERVE_MODES = ("layerwise", "fanout")

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
               refresh_batches: int = 1024) -> str:
    """Pick the serve-time execution mode.

    ``signature`` = (n_nodes, n_edges, batch_class, n_layers);
    ``expansion_edges`` is the static padded edge-slot count of ONE
    fan-out batch of this class (summed over its block signatures);
    ``refresh_batches`` amortizes the layer-wise recompute over the
    batches expected between refreshes; ``op_name`` names the plan-log
    row the rest of the planner will record (A9). Ties go to
    ``layerwise``.
    """
    if requested == "auto":
        return min(SERVE_MODES, key=lambda m: _serve_cost(
            m, signature, expansion_edges, refresh_batches))
    if requested not in SERVE_MODES:
        raise ValueError(f"unknown serve mode {requested!r}; expected one "
                         f"of {SERVE_MODES + ('auto',)}")
    return requested


# --------------------------------------------------------------------- #
# block backward planning (repro/core/planner.py:972-1075)
# --------------------------------------------------------------------- #
BLOCK_BWD_STRATEGIES = ("gather", "scatter")

_BLOCK_BWD_PLANS: Dict[Tuple, str] = {}
_WARNED: Set[Tuple[str, str]] = set()
# the JAX cost model's relative element-op throughputs on the CPU (its
# "cpu" row, the two entries the block backward reads), and its constants
_CPU_THROUGHPUT = {"push": 6.0, "segment": 1.0}
_BWD_COLLISION_SLOTS = 1_000_000   # full-serialization edge-slot scale
_BWD_GATHER_REORDER = 0.45         # gather's extra work vs one segment pass


def _block_bwd_cost(strategy: str, signature: Tuple[int, int, int, int],
                    d: int) -> float:
    """Estimated cost of differentiating one block op (element-ops)."""
    n_src, _, slots, _ = signature
    tp = _CPU_THROUGHPUT
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


def _warn_fallback(spec_name: str, requested: str, chosen: str) -> None:
    key = (spec_name, requested)
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(f"strategy {requested!r} does not support {spec_name!r}"
                  f"; falling back to {chosen!r}", stacklevel=3)


def plan_block_vjp(signature: Tuple[int, int, int, int], spec, d: int,
                   requested: str = "auto", gather_available: bool = True,
                   device: str = "cpu") -> str:
    """Pick the backward (differentiation) strategy of one block op,
    memoized per (signature, op, width, requested, gather_available,
    device type). A pinned strategy the spec does not support falls back
    to 'scatter' with a one-time warning, as in JAX."""
    key = (tuple(signature), spec.name, int(d), requested,
           bool(gather_available), device)
    chosen = _BLOCK_BWD_PLANS.get(key)
    if chosen is not None:
        return chosen

    def ok(s):
        return (block_bwd_supports(s, spec)
                and (s != "gather" or gather_available))

    if requested == "auto":
        if not ok("gather"):
            chosen = "scatter"
        elif device == "cuda":
            chosen = "gather"
        else:
            chosen = min(BLOCK_BWD_STRATEGIES,
                         key=lambda s: _block_bwd_cost(s, signature, d))
    elif requested not in BLOCK_BWD_STRATEGIES:
        raise ValueError(
            f"unknown block backward strategy {requested!r}; expected "
            f"one of {BLOCK_BWD_STRATEGIES + ('auto',)}")
    elif ok(requested):
        chosen = requested
    else:
        chosen = "scatter"
        _warn_fallback(f"block_bwd:{spec.name}", requested, chosen)
    _BLOCK_BWD_PLANS[key] = chosen
    return chosen


# --------------------------------------------------------------------- #
# the per-graph pack cache (repro/core/planner.py:204-419, its packs)
# --------------------------------------------------------------------- #
_DEFAULT_ELL_CAP = 64
_DEFAULT_TILE_GEOM = (128, 128, 256)    # (bm, bk, eb), build_tiles' own
_PACK_BUILDS: Counter = Counter()


def pack_build_totals() -> Dict[str, int]:
    """How many packs of each kind were built (not reused) so far."""
    return dict(_PACK_BUILDS)


class PlanCache:
    """The blocked packs of one graph, each built on first use and kept.

    ``ell(cap)``, ``tiles(bm, bk, eb)``, ``ell_uniform(width)`` and
    ``ell_ragged()`` build from the graph's host index and upload once;
    :meth:`peek` returns a default-geometry pack only if it was built.
    The graph is held weakly, as in JAX: a cache never keeps its graph
    alive."""

    def __init__(self, graph, ell_cap: int = _DEFAULT_ELL_CAP):
        self._gref = weakref.ref(graph)
        self.ell_cap = int(ell_cap)
        self._ell: Optional[ELLPack] = None
        self._tiles: Optional[TilePack] = None
        self._ragged: Optional[ELLPack] = None
        self._ell_by_cap: Dict[int, ELLPack] = {}
        self._tiles_by_geom: Dict[Tuple[int, int, int], TilePack] = {}
        self._uniform: Dict[int, ELLClass] = {}

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
        moves to the keyed memo, and one built earlier at the new cap (if
        any) becomes the default, so no call ever gets a pack with the
        wrong blocking."""
        cap = int(cap)
        if cap == self.ell_cap:
            return
        if self._ell is not None:
            self._ell_by_cap[self.ell_cap] = self._ell
        self._ell = self._ell_by_cap.pop(cap, None)
        self.ell_cap = cap

    def ell(self, width_cap: Optional[int] = None) -> ELLPack:
        cap = self.ell_cap if width_cap is None else int(width_cap)
        if cap == self.ell_cap:
            if self._ell is None:
                self._ell = _built("ell", build_ell(self._graph(), cap))
            return self._ell
        if cap not in self._ell_by_cap:
            self._ell_by_cap[cap] = _built("ell",
                                           build_ell(self._graph(), cap))
        return self._ell_by_cap[cap]

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
            self._uniform[width] = _built(
                "ell_uniform", build_ell_uniform(self._graph(), width))
        return self._uniform[width]

    def ell_ragged(self) -> ELLPack:
        """Row-complete ragged ELL (``build_ell_ragged``): the fused
        attention's backward reads it (``core/edge_softmax.py``)."""
        if self._ragged is None:
            self._ragged = _built("ell_ragged",
                                  build_ell_ragged(self._graph()))
        return self._ragged


def _built(kind: str, pack):
    _PACK_BUILDS[kind] += 1
    return pack


_CACHES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_CACHES_LOCK = threading.Lock()


def get_plan_cache(g) -> PlanCache:
    """The process-wide :class:`PlanCache` of graph ``g``, made once and
    kept for as long as ``g`` lives."""
    cache = _CACHES.get(g)
    if cache is None:
        with _CACHES_LOCK:
            cache = _CACHES.get(g)
            if cache is None:
                cache = _CACHES[g] = PlanCache(g)
    return cache
