"""Low-overhead metrics registry: counters, gauges, log2 histograms (a
copy of ``repro/obs/metrics.py``, which imports no JAX; the port keeps
its own so it never imports ``repro``).

* **Thread-safe** — serve requester threads hit the same instruments
  concurrently; every instrument guards its state with its own lock so
  contention stays per-instrument, not registry-wide.
* **Zero-cost when disabled** — ``REPRO_TELEMETRY=0`` (or
  :func:`set_enabled` ``(False)``) makes every registry accessor return
  a shared null instrument whose methods are no-ops; nothing is
  allocated, registered, or locked.
* **Fixed log2 buckets** — histograms bucket a value ``v > 0`` by
  ``floor(log2(v))`` clamped to ``[lo, hi]``, so observation is O(1)
  with no per-histogram configuration to drift between runs. The
  default range ``[-20, 4]`` spans ~1 µs to ~16 s in seconds.

The module-level :data:`REGISTRY` is the process-wide default; the
``counter``/``gauge``/``histogram``/``snapshot``/``reset_metrics``
functions delegate to it.
"""
import math
import os
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "snapshot", "reset_metrics",
    "enabled", "set_enabled", "percentile_nearest_rank",
]

_ENABLED = os.environ.get("REPRO_TELEMETRY", "1") != "0"


def enabled() -> bool:
    """True when telemetry (metrics, spans, plan events) is on."""
    return _ENABLED


def set_enabled(on):
    """Flip the global telemetry switch at runtime (overhead gate uses
    this to compare on/off in one process). Returns the previous value."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


def percentile_nearest_rank(values, p):
    """Nearest-rank percentile over the full sample vector.

    ``sorted(values)[ceil(p/100 * n) - 1]`` — exact for small n (no
    interpolation between a handful of points), standard for large n.
    """
    if not 0 < p <= 100:
        raise ValueError(f"percentile p must be in (0, 100], got {p}")
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of empty sample")
    k = math.ceil(p / 100.0 * len(xs))
    return xs[max(0, k - 1)]


class Counter:
    """Monotonic counter."""
    __slots__ = ("name", "_lock", "_n")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._n = 0

    def inc(self, n=1):
        with self._lock:
            self._n += n

    @property
    def value(self):
        with self._lock:
            return self._n

    def _snapshot(self):
        return {"type": "counter", "value": self.value}


class Gauge:
    """Last-write-wins scalar."""
    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v):
        with self._lock:
            self._v = float(v)

    @property
    def value(self):
        with self._lock:
            return self._v

    def _snapshot(self):
        return {"type": "gauge", "value": self.value}


class Histogram:
    """Fixed log2-bucket histogram.

    Bucket ``i`` (for ``lo <= i <= hi``) counts values in
    ``[2**i, 2**(i+1))``; values below ``2**lo`` land in bucket ``lo``,
    values at or above ``2**(hi+1)`` land in bucket ``hi``, and
    non-positive values land in a dedicated underflow bucket. Also
    tracks count/sum/min/max exactly.
    """
    __slots__ = ("name", "lo", "hi", "_lock", "_buckets", "_underflow",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, name, lo=-20, hi=4):
        if hi < lo:
            raise ValueError(f"histogram range hi < lo: [{lo}, {hi}]")
        self.name = name
        self.lo = lo
        self.hi = hi
        self._lock = threading.Lock()
        self._buckets = [0] * (hi - lo + 1)
        self._underflow = 0
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def bucket_index(self, v):
        """Bucket exponent for value ``v`` (None for the underflow
        bucket). ``2**k`` maps to bucket ``k``: frexp gives
        ``v = m * 2**e`` with ``m in [0.5, 1)``, so ``floor(log2 v)``
        is ``e - 1`` without float-log rounding at the boundaries."""
        if v <= 0:
            return None
        _, e = math.frexp(v)
        return min(self.hi, max(self.lo, e - 1))

    def observe(self, v):
        v = float(v)
        idx = self.bucket_index(v)
        with self._lock:
            if idx is None:
                self._underflow += 1
            else:
                self._buckets[idx - self.lo] += 1
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def buckets(self):
        """List of ``(2**i, count)`` rows (bucket lower bounds), plus
        the underflow bucket as ``(None, count)`` when populated."""
        with self._lock:
            rows = [(2.0 ** (self.lo + i), n)
                    for i, n in enumerate(self._buckets)]
            if self._underflow:
                rows.insert(0, (None, self._underflow))
            return rows

    def quantile(self, q):
        """Approximate quantile: upper bound of the bucket holding the
        nearest-rank sample. None when empty."""
        with self._lock:
            if self._count == 0:
                return None
            rank = max(1, math.ceil(q * self._count))
            seen = self._underflow
            if rank <= seen:
                return 2.0 ** self.lo
            for i, n in enumerate(self._buckets):
                seen += n
                if rank <= seen:
                    return 2.0 ** (self.lo + i + 1)
            return self._max

    def _snapshot(self):
        with self._lock:
            out = {
                "type": "histogram",
                "count": self._count,
                "sum": self._sum,
                "lo": self.lo,
                "hi": self.hi,
                "buckets": {str(self.lo + i): n
                            for i, n in enumerate(self._buckets) if n},
            }
            if self._underflow:
                out["underflow"] = self._underflow
            if self._count:
                out["min"] = self._min
                out["max"] = self._max
                out["mean"] = self._sum / self._count
        return out


class _NullInstrument:
    """Shared do-nothing instrument returned while telemetry is off."""
    __slots__ = ()
    name = "<disabled>"
    value = 0
    count = 0
    sum = 0.0

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass

    def buckets(self):
        return []

    def quantile(self, q):
        return None


_NULL = _NullInstrument()


class MetricsRegistry:
    """Name → instrument map with get-or-create accessors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments = {}

    def _get(self, name, cls, *args):
        if not _ENABLED:
            return _NULL
        inst = self._instruments.get(name)      # atomic: no lock
        if type(inst) is cls:
            return inst
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name):
        return self._get(name, Counter)

    def gauge(self, name):
        return self._get(name, Gauge)

    def histogram(self, name, lo=-20, hi=4):
        return self._get(name, Histogram, lo, hi)

    def snapshot(self):
        """JSON-able dict of every registered instrument's state."""
        with self._lock:
            instruments = sorted(self._instruments.items())
        return {name: inst._snapshot() for name, inst in instruments}

    def reset(self):
        """Drop every registered instrument (tests / bench isolation)."""
        with self._lock:
            self._instruments.clear()


REGISTRY = MetricsRegistry()


def counter(name):
    return REGISTRY.counter(name)


def gauge(name):
    return REGISTRY.gauge(name)


def histogram(name, lo=-20, hi=4):
    return REGISTRY.histogram(name, lo, hi)


def snapshot():
    return REGISTRY.snapshot()


def reset_metrics():
    REGISTRY.reset()
