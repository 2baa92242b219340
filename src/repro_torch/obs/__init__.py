"""repro_torch.obs — telemetry of the port (port of ``repro/obs``): the
metrics registry, spans and measured events, and compile-signature
accounting. One switch turns it all off (``REPRO_TELEMETRY=0``, or
:func:`set_enabled` at runtime).

* :mod:`.metrics` — a thread-safe registry of counters / gauges /
  log2-bucket histograms, so one :func:`snapshot` describes a run;
* :mod:`.spans` — ``with span("name") as sp: ...; sp.fence(out)``
  wall-time tracing that waits for the device at span exit when fenced,
  ``span(name, device=True)`` device time read later without a host
  wait (:func:`resolve_device_spans`), ``record_function`` annotations
  on a running ``torch.profiler``'s clock, exportable as Chrome-trace
  JSON (:func:`export_chrome_trace`);
* :mod:`.events` — the planner's plan events (predicted cost per
  decision) and the measured device time of eager op executions
  (:func:`timed`, no fence), joined by :func:`drift_report`;
* :mod:`.signatures` — :class:`SignatureTracker`.

``repro_torch.obs`` imports only torch and the standard library, so
every other subpackage can report here without import cycles.
"""
from .events import (DRIFT_FIELDS, PLAN_EVENT_FIELDS, clear_events,
                     drift_report, family_of, measured_event,
                     measured_events, plan_event, plan_events, timed)
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      counter, enabled, gauge, histogram,
                      percentile_nearest_rank, reset_metrics, set_enabled,
                      snapshot)
from .signatures import SignatureTracker
from .spans import (Span, clear_trace, export_chrome_trace, fence,
                    resolve_device_spans, span, span_coverage, trace_events)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
    "counter", "gauge", "histogram", "snapshot", "reset_metrics",
    "enabled", "set_enabled", "percentile_nearest_rank",
    "Span", "span", "fence", "export_chrome_trace", "trace_events",
    "clear_trace", "span_coverage", "resolve_device_spans",
    "PLAN_EVENT_FIELDS", "DRIFT_FIELDS", "plan_event", "plan_events",
    "drift_report", "family_of",
    "measured_event", "timed", "measured_events", "clear_events",
    "SignatureTracker",
]
