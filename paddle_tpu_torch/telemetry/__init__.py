"""Telemetry of the port (port of ``paddle_tpu/telemetry``): metrics and
tracing for the serving stack.

One process-wide metric registry (Counter/Gauge/Histogram with labels),
one bounded span ring, per-request timelines, a flight recorder,
exporters (Prometheus text, JSON snapshot, Chrome trace) and cross-rank
aggregation over a key-value store. Everything is gated on
``FLAGS_telemetry``: off (the default), every helper is a guarded no-op
(no samples retained, no thread started, one dict lookup on the hot
path).

The call-site idiom (metric and span names literal; dynamic context in
labels or span attributes)::

    from paddle_tpu_torch import telemetry

    telemetry.counter("serving_requests_total").inc()
    telemetry.gauge("serving_queue_depth").set(depth)
    telemetry.histogram("serving_ttft_seconds").observe(dt)
    with telemetry.span("serving/engine_step", cat="Serving", step=n):
        ...

Flags (``paddle_tpu_torch/flags.py``): ``FLAGS_telemetry`` (the master
switch), ``_reservoir``, ``_spans_max``, ``_export_interval``,
``_export_path``, ``_requests_max``, ``_request_events_max``,
``_flight_steps`` and ``_flight_dir``.

Producers in the port: the serving engine, its metrics, scheduler and
robustness paths (families, spans, flight steps and dumps, request
timelines), ``distributed/watchdog.report_degraded`` and the fault
registry. The JAX package's training producers (checkpoint, resilient
runner, comm watchdog) and the profiler's RecordEvent rows have no
counterpart yet.
"""

from __future__ import annotations

from .aggregate import (  # noqa: F401
    KEY_PREFIX, collect_fleet, format_fleet, merge_docs, push_snapshot,
)
from .exporters import (  # noqa: F401
    PeriodicExporter, chrome_trace, maybe_start_exporter, prometheus_text,
    request_tid, snapshot_doc, stop_exporter, write_chrome_trace,
)
from .flight import (  # noqa: F401
    FlightRecorder, dump_flight, flight, format_flight, record_flight_step,
    reset_flight,
)
from .registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricRegistry, Reservoir, counter,
    enabled, gauge, histogram, registry, reset, snapshot,
)
from .requests import (  # noqa: F401
    RequestLog, begin_request, bounded_event_append,
    format_request_timeline, record_request_event, request_log,
    request_timeline, reset_requests, snapshot_requests,
)
from .tracer import (  # noqa: F401
    SpanTracer, drain_spans, record_span, reset_spans, snapshot_spans,
    span, timed, tracer,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry", "Reservoir",
    "counter", "gauge", "histogram", "enabled", "registry", "snapshot",
    "reset",
    "SpanTracer", "span", "timed", "record_span", "tracer",
    "snapshot_spans", "drain_spans", "reset_spans",
    "prometheus_text", "snapshot_doc", "chrome_trace",
    "write_chrome_trace", "PeriodicExporter", "maybe_start_exporter",
    "stop_exporter", "request_tid",
    "RequestLog", "begin_request", "record_request_event",
    "snapshot_requests", "request_timeline", "reset_requests",
    "bounded_event_append", "format_request_timeline", "request_log",
    "FlightRecorder", "flight", "record_flight_step", "dump_flight",
    "reset_flight", "format_flight",
    "KEY_PREFIX", "push_snapshot", "collect_fleet", "merge_docs",
    "format_fleet",
    "declare_defaults", "reset_all",
]


def declare_defaults() -> None:
    """Materialise the cross-cutting zero-valued families so a snapshot
    taken before any failure still SHOWS the failure channels (a fleet
    dashboard needs 'watchdog_degraded_total 0', not a missing series).
    The same five families as the JAX package, some of whose producers
    the port does not have yet. No-op while telemetry is off."""
    if not enabled():
        return
    counter("watchdog_degraded_total")
    counter("store_retry_total")
    counter("fault_injected_total")
    counter("resilient_recoveries_total")
    counter("comm_watchdog_timeouts_total")


def reset_all() -> None:
    """Tests/bench: clear metrics, spans, request timelines AND the
    flight recorder (flag state untouched)."""
    reset()
    reset_spans()
    reset_requests()
    reset_flight()
