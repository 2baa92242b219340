"""Execution planning (port of ``repro/core/planner.py``; the serve rows).

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
configuration. The plan log (``serve:<op>`` rows, measured times) and the
kernel-strategy rows come with the rest of the planner (ROADMAP A9).
"""
from __future__ import annotations

from typing import Tuple

__all__ = ["SERVE_MODES", "plan_serve"]

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
