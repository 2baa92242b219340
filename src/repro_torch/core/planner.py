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
"""
from __future__ import annotations

import warnings
from typing import Dict, Set, Tuple

__all__ = ["SERVE_MODES", "plan_serve", "BLOCK_BWD_STRATEGIES",
           "block_bwd_supports", "plan_block_vjp"]

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
