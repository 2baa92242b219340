"""Structured plan-event stream: predicted cost vs measured wall time
(port of ``repro/obs/events.py``).

Every planner decision (``gspmm``, ``block:*``, ``block_bwd:*``,
``hetero:*``, ``sddmm:*``, ``attn:*``, ``serve:infer``) flows through
:func:`plan_event`, which records the cost model's *predicted* cost for
the chosen strategy next to the decision. When the op actually runs
eagerly (serve refresh, fan-out inference, the sampled-training drift
probe, autotune measurement), :func:`measured_event` / :func:`timed`
record *measured* wall time under the same op key.

:func:`drift_report` joins the two. Predicted costs are relative
element-op counts whose absolute scale differs per plan-row family, so
the report fits one scale per family and dtype (median of
measured/predicted over that family's ops) and flags ops whose
normalized ratio falls outside ``[1/threshold, threshold]`` — i.e. ops
where the cost model's *ranking within its own family* has drifted from
reality.

PyTorch runs every call eagerly, so :func:`timed` fences and times each
call while telemetry is on — except while the current CUDA stream is
being captured into a graph, where nothing runs and a timing would
measure the capture (the JAX package skips calls under a trace the same
way). Callers that must not fence (an op autograd records inside a
training step, the port's analogue of JAX's vjp trace) do not call it.

The record schemas (:data:`PLAN_EVENT_FIELDS`, :data:`DRIFT_FIELDS`) are
the JAX package's, letter for letter.
"""
import threading
import time

import torch

from . import metrics as _metrics
from .metrics import enabled
from .spans import fence

__all__ = ["PLAN_EVENT_FIELDS", "DRIFT_FIELDS", "plan_event",
           "measured_event", "timed", "plan_events", "measured_events",
           "drift_report", "clear_events", "family_of", "enabled"]

# Extend by appending — never reorder or rename (BENCH_*.json consumers
# of the JAX package read these dicts).
PLAN_EVENT_FIELDS = (
    "op", "family", "requested", "chosen", "count",
    "predicted_cost", "measured_calls", "measured_total_s",
    "measured_mean_s", "dtype",
)
DRIFT_FIELDS = (
    "op", "family", "requested", "chosen", "predicted_cost",
    "measured_calls", "measured_mean_s", "family_scale",
    "ratio", "drifted", "dtype",
)

_LOCK = threading.Lock()
# (op, requested, chosen, dtype) -> {"count", "predicted_cost"}
_PLANS = {}
# op -> {"calls": int, "total_s": float, "min_s": float, "max_s": float}
_MEASURED = {}

_FAMILIES = ("block_bwd", "block", "hetero", "sddmm", "attn", "serve",
             "partitioned")


def family_of(op):
    """Plan-row family of an op key: the prefix before ':' for
    prefixed rows, ``gspmm`` for bare binary-reduce spec names."""
    head, sep, _ = op.partition(":")
    if sep and head in _FAMILIES:
        return head
    return "gspmm"


def plan_event(op, requested, chosen, predicted_cost=None, dtype=None):
    """Record one planner decision row. ``predicted_cost`` is the cost
    model's estimate for the *chosen* strategy (relative element-ops), or
    None where the site has no cost model input. ``dtype`` is the operand
    element type the decision was made for (a string, e.g. "float32"), or
    None at sites with no operand in hand — rows are keyed on it."""
    if not enabled():
        return
    key = (str(op), str(requested), str(chosen),
           None if dtype is None else str(dtype))
    with _LOCK:
        row = _PLANS.get(key)
        if row is None:
            row = {"count": 0, "predicted_cost": None}
            _PLANS[key] = row
        row["count"] += 1
        if predicted_cost is not None:
            row["predicted_cost"] = float(predicted_cost)


def measured_event(op, seconds):
    """Record one measured execution of ``op`` (seconds of wall time,
    fenced by the caller)."""
    if not enabled():
        return
    s = float(seconds)
    with _LOCK:
        row = _MEASURED.get(op)
        if row is None:
            row = {"calls": 0, "total_s": 0.0, "min_s": s, "max_s": s}
            _MEASURED[op] = row
        row["calls"] += 1
        row["total_s"] += s
        row["min_s"] = min(row["min_s"], s)
        row["max_s"] = max(row["max_s"], s)


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def timed(op, thunk):
    """Run ``thunk()``; while telemetry is on and no CUDA graph is being
    captured, fence the result (:func:`~repro_torch.obs.spans.fence`) and
    record the wall time as a measured event for ``op``. Returns the
    thunk's result."""
    if not enabled() or _capturing():
        return thunk()
    t0 = time.perf_counter()
    out = thunk()
    fence(out)
    measured_event(op, time.perf_counter() - t0)
    return out


def measured_events():
    """op → ``{"calls", "total_s", "min_s", "max_s", "mean_s"}`` of every
    measured op, sorted by op key."""
    with _LOCK:
        rows = {k: dict(v) for k, v in sorted(_MEASURED.items())}
    for row in rows.values():
        row["mean_s"] = row["total_s"] / row["calls"]
    return rows


def plan_events():
    """The plan-event stream as a list of dicts in the
    :data:`PLAN_EVENT_FIELDS` schema, joined with per-op measurements,
    sorted by op key."""
    with _LOCK:
        plans = {k: dict(v) for k, v in _PLANS.items()}
        measured = {k: dict(v) for k, v in _MEASURED.items()}
    rows = []
    for (op, requested, chosen, dtype) in sorted(
            plans, key=lambda k: (k[0], k[1], k[2], k[3] or "")):
        p = plans[(op, requested, chosen, dtype)]
        m = measured.get(op)
        rows.append({
            "op": op,
            "family": family_of(op),
            "requested": requested,
            "chosen": chosen,
            "count": p["count"],
            "predicted_cost": p["predicted_cost"],
            "measured_calls": m["calls"] if m else 0,
            "measured_total_s": m["total_s"] if m else None,
            "measured_mean_s": (m["total_s"] / m["calls"]) if m else None,
            "dtype": dtype,
        })
    return rows


def drift_report(threshold=4.0):
    """Predicted-vs-measured drift rows (:data:`DRIFT_FIELDS` schema).

    One row per plan decision that has both a predicted cost and a
    measurement for its op. ``family_scale`` is the median
    measured/predicted ratio within the row's family and dtype
    (predicted costs are relative, so only within-family ranking is
    meaningful); ``ratio`` is the row's measured/predicted normalized by
    that scale, and ``drifted`` flags ratios outside
    ``[1/threshold, threshold]``. Sorted worst first.
    """
    if threshold <= 1.0:
        raise ValueError(f"drift threshold must be > 1, got {threshold}")
    rows = [r for r in plan_events()
            if r["predicted_cost"] and r["predicted_cost"] > 0
            and r["measured_mean_s"] is not None]
    by_family = {}
    for r in rows:
        by_family.setdefault((r["family"], r["dtype"]), []).append(
            r["measured_mean_s"] / r["predicted_cost"])
    scales = {fam: _metrics.percentile_nearest_rank(ratios, 50)
              for fam, ratios in by_family.items()}
    out = []
    for r in rows:
        scale = scales[(r["family"], r["dtype"])]
        raw = r["measured_mean_s"] / r["predicted_cost"]
        ratio = raw / scale if scale > 0 else None
        drifted = (ratio is not None
                   and not (1.0 / threshold <= ratio <= threshold))
        out.append({
            "op": r["op"],
            "family": r["family"],
            "requested": r["requested"],
            "chosen": r["chosen"],
            "predicted_cost": r["predicted_cost"],
            "measured_calls": r["measured_calls"],
            "measured_mean_s": r["measured_mean_s"],
            "family_scale": scale,
            "ratio": ratio,
            "drifted": drifted,
            "dtype": r["dtype"],
        })
    out.sort(key=lambda r: -(r["ratio"] or 0))
    return out


def clear_events():
    """Drop all plan and measured events (tests / bench isolation)."""
    with _LOCK:
        _PLANS.clear()
        _MEASURED.clear()
