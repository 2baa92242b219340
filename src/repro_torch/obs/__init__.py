"""repro_torch.obs — telemetry of the port (port of ``repro/obs``): the
metrics registry, spans and measured events, and compile-signature
accounting. One switch turns it all off (``REPRO_TELEMETRY=0``, or
:func:`set_enabled` at runtime).

* :mod:`.metrics` — a thread-safe registry of counters / gauges /
  log2-bucket histograms, so one :func:`snapshot` describes a run;
* :mod:`.spans` — ``with span("name") as sp: ...; sp.fence(out)``
  wall-time tracing that waits for the device at span exit, exportable
  as Chrome-trace JSON (:func:`export_chrome_trace`);
* :mod:`.events` — measured wall time of eager op executions
  (:func:`timed`); the planner's plan events and the drift report come
  with the planner (ROADMAP queue A, item 6);
* :mod:`.signatures` — :class:`SignatureTracker`.

``repro_torch.obs`` imports only torch and the standard library, so
every other subpackage can report here without import cycles.
"""
from .events import clear_events, measured_event, measured_events, timed
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      counter, enabled, gauge, histogram,
                      percentile_nearest_rank, reset_metrics, set_enabled,
                      snapshot)
from .signatures import SignatureTracker
from .spans import (Span, clear_trace, export_chrome_trace, fence, span,
                    span_coverage, trace_events)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "snapshot", "reset_metrics",
    "enabled", "set_enabled", "percentile_nearest_rank",
    "Span", "span", "fence", "export_chrome_trace", "trace_events",
    "clear_trace", "span_coverage",
    "measured_event", "timed", "measured_events", "clear_events",
    "SignatureTracker",
]
