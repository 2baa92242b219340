"""Measured events: wall time of eager op executions (port of
``repro/obs/events.py:89-118,198``).

:func:`measured_event` / :func:`timed` record the *measured* wall time of
an op under its plan-log key (``block:<op>``, ``block_bwd:<op>``,
``serve:infer``); :func:`measured_events` reads them back.

PyTorch runs every call eagerly, so :func:`timed` fences and times each
call while telemetry is on — except while the current CUDA stream is
being captured into a graph, where nothing runs and a timing would
measure the capture (the JAX package skips calls under a trace the same
way, with ``jax.core.trace_state_clean``).

The plan-event half of the JAX module (``plan_event``, ``plan_events``,
``drift_report``, ``family_of``) records the planner's predicted costs; it
comes with the planner (ROADMAP queue A, item 6).
"""
import threading
import time

import torch

from .metrics import enabled
from .spans import fence

__all__ = ["measured_event", "timed", "measured_events", "clear_events",
           "enabled"]

_LOCK = threading.Lock()
# op -> {"calls": int, "total_s": float, "min_s": float, "max_s": float}
_MEASURED = {}


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


def clear_events():
    """Drop all measured events (tests / bench isolation)."""
    with _LOCK:
        _MEASURED.clear()
