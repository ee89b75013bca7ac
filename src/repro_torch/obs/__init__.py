"""Streaming observability for the fold-schedule serving stack.

* ``obs.metrics`` — a bounded metrics registry: counters, gauges and
  fixed-memory log-bucketed histograms, with Prometheus text exposition
  and a JSON snapshot.
* ``obs.trace``   — request-lifecycle tracing through an injectable clock
  with deterministic span IDs, exported as Chrome trace-event JSON.
* ``obs.folds``   — per-schedule streaming counters: measured dispatch
  time joined with the MAVeC analytical model per ``ScheduleKey``.
* ``obs.report``  — the CLI (``python -m repro_torch.obs.report``).

Everything defaults to the no-op recorder (``trace.NULL_TRACER``).
"""
from repro_torch.obs.metrics import (Counter, Gauge, LogHistogram,
                                     MetricsRegistry,
                                     validate_metrics_snapshot)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Tracer,
                                   validate_trace)

__all__ = [
    "Counter", "Gauge", "LogHistogram", "MetricsRegistry",
    "validate_metrics_snapshot",
    "Tracer", "NullTracer", "NULL_TRACER", "validate_trace",
]
