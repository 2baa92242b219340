"""Span tracing with device timing, device fencing and Chrome-trace
export (port of ``repro/obs/spans.py``).

``with span("compute") as sp: out = f(x); sp.fence(out)`` records a
wall-time interval. At span exit the fence value (if any) is waited for
*before* the stop timestamp is taken — :func:`fence` synchronizes the
device of every CUDA tensor in it (``torch.cuda.synchronize``; the JAX
package's fence is ``jax.block_until_ready``) — so asynchronously
launched device work is attributed to the span that launched it instead
of leaking into whichever span happens to wait next.

``span(name, device=True)`` times the span on the device without a host
wait: a timing ``torch.cuda.Event`` (from a small reused pool) is
recorded at entry and at exit on the stream current at entry — none
while that stream is being captured into a CUDA graph, which is asked
once, at entry — and the elapsed time lands in the event's
``args["device_ms"]`` later. ``device`` may also be the
``torch.device`` of the span's operands, which names the CUDA device to
time on (a host device times nothing). Every :data:`RESOLVE_EVERY`-th
device span exit resolves the oldest pending pairs whose end event has
completed (``query()``, no wait); :func:`resolve_device_spans`
``(wait=True)`` is the one call that waits. At most
:data:`MAX_PENDING` pairs wait at once; a span past that is recorded on
the host alone and counted under ``trace.dropped_device``. On the CPU
(CUDA not initialized) a device span is a host span. A device span must
not enclose the start of a graph capture.

While a ``torch.profiler`` session records, every span also opens a
``torch.profiler.record_function`` of its name, so its interval appears
as a ``user_annotation`` event in the profiler's Chrome trace, on the
profiler's clock, beside the kernels it launched.

Spans nest (a per-thread depth, the span's ``id`` and its enclosing
span's ``parent`` id on the same thread are recorded with each event)
and are thread-safe: requester threads and the serve loop trace
concurrently into one shared buffer. :func:`export_chrome_trace` writes
the buffer as Chrome-trace JSON (``{"traceEvents": [...]}``,
complete-event ``"ph": "X"`` records with microsecond timestamps)
loadable in Perfetto or chrome://tracing. :func:`span_coverage` reports
the fraction of a wall-clock window covered by top-level spans.

Every span also feeds the metrics registry histogram ``span.<name>``
(seconds of host time), so span statistics appear in metrics snapshots
without parsing the trace.
"""
import collections
import itertools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _profiler

from . import metrics as _metrics

__all__ = ["Span", "span", "fence", "export_chrome_trace", "trace_events",
           "clear_trace", "span_coverage", "resolve_device_spans",
           "MAX_PENDING", "RESOLVE_EVERY"]

# Process epoch for trace timestamps: Chrome traces want microseconds
# on a shared monotonic axis, not wall-clock.
_T0_NS = time.perf_counter_ns()

_LOCK = threading.Lock()
_EVENTS = []
# Bounded buffer: long sessions must not grow memory without limit.
# Overflow drops new events and counts them (surfaced in snapshots).
_MAX_EVENTS = 500_000

# Device-timed spans whose end event has not been read yet, oldest
# first: (event dict, (start, end, device index, stream), on_device_ms);
# the timing events free for reuse, by CUDA device index; and the
# ``torch.cuda.Stream`` of each (device index, raw stream) seen, since
# building one per event would cost more than recording the event. The
# pending pairs are read every ``RESOLVE_EVERY`` device span exits, not
# at each: a read is a driver call per pair.
MAX_PENDING = 8192
RESOLVE_EVERY = 32
_EXITS = itertools.count(1)
_PENDING = collections.deque()
_POOL = {}
_STREAMS = {}
_IDS = itertools.count(1)

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


def _capturing() -> bool:
    """Is the current CUDA stream being captured into a graph?"""
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def _current_stream(index: int):
    key = (index, torch._C._cuda_getCurrentRawStream(index))
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.current_stream(index)
    return stream


def _device_events(device):
    """``(start, end, device index, stream)``: two timing events for the
    current stream of ``device`` (True: the current CUDA device), the
    start recorded (the end is recorded on the same stream); or None
    where nothing can be timed on a device (a host device, CUDA not
    initialized, or the stream being captured into a graph)."""
    if device is True:
        if not torch.cuda.is_initialized():
            return None
        index = None
    elif device.type == "cuda":
        index = device.index
    else:
        return None
    if torch.cuda.is_current_stream_capturing():
        return None
    if index is None:
        index = torch.cuda.current_device()
    stream = _current_stream(index)
    free = _POOL.get(index)
    pair = []
    for _ in range(2):
        try:
            pair.append(free.pop())     # atomic: no lock
        except (AttributeError, IndexError):
            pair.append(torch.cuda.Event(enable_timing=True))
    pair[0].record(stream)
    return pair[0], pair[1], index, stream


def _free(index, *events):
    _POOL.setdefault(index, []).extend(events)


def _resolve_ready() -> list:
    """Pop the oldest pending pairs whose events have completed, writing
    ``device_ms`` into their events; returns the callbacks to run (after
    the lock is released) with their readings. Never waits."""
    done = []
    with _LOCK:
        while _PENDING:
            ev, (start, end, index, _), on_ms = _PENDING[0]
            if not end.query():     # one stream: the start is done too
                break
            _PENDING.popleft()
            ms = start.elapsed_time(end)
            ev["args"]["device_ms"] = ms
            _free(index, start, end)
            if on_ms is not None:
                done.append((on_ms, ms))
    return done


def resolve_device_spans(wait=False) -> int:
    """Write ``device_ms`` into every device-timed span whose events have
    completed; with ``wait``, first wait for each pending end event (the
    one call here that may synchronize: nothing on a hot path calls it
    with ``wait``). Returns the number of spans still pending."""
    while True:
        for on_ms, ms in _resolve_ready():
            on_ms(ms)
        with _LOCK:
            oldest = _PENDING[0] if _PENDING else None
        if oldest is None or not wait:
            break
        oldest[1][1].synchronize()
    return len(_PENDING)


class Span:
    """One open span. ``fence(x)`` registers a value to wait for at
    exit; exiting also accepts exceptions (the span is recorded either
    way). ``on_device`` says whether it is timed on the device (its
    ``args["device_ms"]`` arrives unless the pending bound dropped it);
    after exit, ``seconds`` is its host duration."""
    __slots__ = ("name", "cat", "args", "depth", "id", "parent", "seconds",
                 "on_device", "_t0_ns", "_fence", "_dev", "_on_ms", "_rf")

    def __init__(self, name, cat, args, depth, parent, t0_ns, dev=None,
                 on_ms=None, rf=None):
        self.name = name
        self.cat = cat
        self.args = args
        self.depth = depth
        self.id = next(_IDS)
        self.parent = parent
        self.seconds = None
        self.on_device = dev is not None
        self._t0_ns = t0_ns
        self._fence = None
        self._dev = dev
        self._on_ms = on_ms
        self._rf = rf

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
        if self._dev is not None:
            self._dev[1].record(self._dev[3])
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        t1_ns = time.perf_counter_ns()
        _tls.depth = self.depth
        _tls.parent = self.parent
        dur_ns = t1_ns - self._t0_ns
        self.seconds = dur_ns / 1e9
        ev = {
            "name": self.name,
            "cat": self.cat,
            "ph": "X",
            "ts": (self._t0_ns - _T0_NS) / 1e3,
            "dur": dur_ns / 1e3,
            "pid": os.getpid(),
            "tid": threading.get_ident(),
            "args": dict(self.args or {}, depth=self.depth, id=self.id,
                         parent=self.parent),
        }
        dev = self._dev
        pending = False
        with _LOCK:
            if len(_EVENTS) < _MAX_EVENTS:
                _EVENTS.append(ev)
            else:
                _metrics.counter("trace.dropped_events").inc()
            if dev is not None and len(_PENDING) < MAX_PENDING:
                _PENDING.append((ev, dev, self._on_ms))
                pending = True
        _metrics.histogram(f"span.{self.name}").observe(self.seconds)
        if dev is not None:
            if not pending:     # past the bound: no device reading
                _free(dev[2], dev[0], dev[1])
                _metrics.counter("trace.dropped_device").inc()
            # opened outside a capture, so the queue may be read
            if next(_EXITS) % RESOLVE_EVERY == 0:
                for on_ms, ms in _resolve_ready():
                    on_ms(ms)
        return False


class _NullSpan:
    __slots__ = ()
    on_device = False
    seconds = None

    def fence(self, value):
        return value

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


def span(name, cat="repro", args=None, device=False, on_device_ms=None):
    """Open a traced span. Returns a no-op span when telemetry is off,
    so instrumented code paths cost one predicate when disabled.

    ``device``: also time the span on the current CUDA stream (module
    docstring): True for the current CUDA device, or the ``torch.device``
    of the span's operands; ``on_device_ms(ms)`` is called once that
    reading is resolved."""
    if not _metrics.enabled():
        return _NULL_SPAN
    depth = getattr(_tls, "depth", 0)
    parent = getattr(_tls, "parent", None)
    rf = None
    if _profiler._is_profiler_enabled:
        rf = torch.profiler.record_function(name)
        rf.__enter__()
    dev = _device_events(device) if device else None
    sp = Span(name, cat, args, depth, parent, time.perf_counter_ns(), dev,
              on_device_ms, rf)
    _tls.depth = depth + 1
    _tls.parent = sp.id
    return sp


def trace_events():
    """Copy of the recorded trace events (Chrome-trace dicts). Never
    waits: a device-timed span's ``device_ms`` is there once resolved
    (:func:`resolve_device_spans`)."""
    with _LOCK:
        return list(_EVENTS)


def clear_trace():
    """Drop the recorded events, resolving the pending device readings
    first (a wait), so none of an earlier span lands after the clear."""
    resolve_device_spans(wait=True)
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
