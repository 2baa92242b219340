"""Span tracing with device fencing and Chrome-trace export (port of
``repro/obs/spans.py``).

``with span("compute") as sp: out = f(x); sp.fence(out)`` records a
wall-time interval. At span exit the fence value (if any) is waited for
*before* the stop timestamp is taken — :func:`fence` synchronizes the
device of every CUDA tensor in it (``torch.cuda.synchronize``; the JAX
package's fence is ``jax.block_until_ready``) — so asynchronously
launched device work is attributed to the span that launched it instead
of leaking into whichever span happens to wait next.

Spans nest (a per-thread depth is recorded with each event) and are
thread-safe: requester threads and the serve loop trace concurrently
into one shared buffer. :func:`export_chrome_trace` writes the buffer
as Chrome-trace JSON (``{"traceEvents": [...]}``, complete-event
``"ph": "X"`` records with microsecond timestamps) loadable in
Perfetto or chrome://tracing. :func:`span_coverage` reports the
fraction of a wall-clock window covered by top-level spans.

Every span also feeds the metrics registry histogram ``span.<name>``
(seconds), so span statistics appear in metrics snapshots without
parsing the trace.
"""
import json
import os
import threading
import time

import torch

from . import metrics as _metrics

__all__ = ["Span", "span", "fence", "export_chrome_trace", "trace_events",
           "clear_trace", "span_coverage"]

# Process epoch for trace timestamps: Chrome traces want microseconds
# on a shared monotonic axis, not wall-clock.
_T0_NS = time.perf_counter_ns()

_LOCK = threading.Lock()
_EVENTS = []
# Bounded buffer: long sessions must not grow memory without limit.
# Overflow drops new events and counts them (surfaced in snapshots).
_MAX_EVENTS = 500_000

_tls = threading.local()


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices of every tensor in ``value`` (a tensor, or a
    tuple / list / dict of them, nested)."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    return out


def fence(value):
    """Wait until the device work producing ``value`` is done: synchronize
    each CUDA device holding one of its tensors (host tensors are ready
    already). Returns ``value``."""
    for dev in _cuda_devices(value, set()):
        torch.cuda.synchronize(dev)
    return value


class Span:
    """One open span. ``fence(x)`` registers a value to wait for at
    exit; exiting also accepts exceptions (the span is recorded either
    way)."""
    __slots__ = ("name", "cat", "args", "depth", "_t0_ns", "_fence")

    def __init__(self, name, cat, args, depth, t0_ns):
        self.name = name
        self.cat = cat
        self.args = args
        self.depth = depth
        self._t0_ns = t0_ns
        self._fence = None

    def fence(self, value):
        """Wait for ``value`` (tensors, or containers of them) before the
        span's stop timestamp is taken."""
        self._fence = value
        return value

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._fence is not None:
            fence(self._fence)
        t1_ns = time.perf_counter_ns()
        _tls.depth = self.depth
        dur_ns = t1_ns - self._t0_ns
        ev = {
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": (self._t0_ns - _T0_NS) / 1e3,
            "dur": dur_ns / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": dict(self.args or {}, depth=self.depth),
        }
        with _LOCK:
            if len(_EVENTS) < _MAX_EVENTS:
                _EVENTS.append(ev)
            else:
                _metrics.counter("trace.dropped_events").inc()
        _metrics.histogram(f"span.{self.name}").observe(dur_ns / 1e9)
        return False


class _NullSpan:
    __slots__ = ()

    def fence(self, value):
        return value

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


def span(name, cat="repro", args=None):
    """Open a traced span. Returns a no-op span when telemetry is off,
    so instrumented code paths cost one predicate when disabled."""
    if not _metrics.enabled():
        return _NULL_SPAN
    depth = getattr(_tls, "depth", 0)
    _tls.depth = depth + 1
    return Span(name, cat, args, depth, time.perf_counter_ns())


def trace_events():
    """Copy of the recorded trace events (Chrome-trace dicts)."""
    with _LOCK:
        return list(_EVENTS)


def clear_trace():
    with _LOCK:
        _EVENTS.clear()


def export_chrome_trace(path):
    """Write the span buffer as Chrome-trace JSON; returns ``path``.

    Load in Perfetto (ui.perfetto.dev) or chrome://tracing.
    """
    with _LOCK:
        events = list(_EVENTS)
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def span_coverage(events=None, tid=None):
    """Fraction of the session window covered by top-level spans.

    The window is [earliest span start, latest span end] over the
    selected events; coverage is the union length of depth-0 spans in
    that window. ``tid`` restricts to one thread (e.g. the serve loop);
    by default all threads' top-level spans contribute to the union.
    Returns 0.0 when there are no events.
    """
    evs = trace_events() if events is None else events
    if tid is not None:
        evs = [e for e in evs if e["tid"] == tid]
    if not evs:
        return 0.0
    t_lo = min(e["ts"] for e in evs)
    t_hi = max(e["ts"] + e["dur"] for e in evs)
    if t_hi <= t_lo:
        return 0.0
    top = sorted((e["ts"], e["ts"] + e["dur"]) for e in evs
                 if e["args"].get("depth", 0) == 0)
    covered = 0.0
    cur_lo = cur_hi = None
    for lo, hi in top:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                covered += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        covered += cur_hi - cur_lo
    return covered / (t_hi - t_lo)
