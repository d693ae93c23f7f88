"""Telemetry exporters (port of ``telemetry/exporters.py``): Prometheus
text, JSON snapshot, Chrome trace, and a periodic background exporter
thread.

Read paths over one registry, span ring and request log:

- ``prometheus_text()``: the text exposition format (0.0.4). Counters
  and gauges export verbatim; histograms export as a summary family
  (``_count``/``_sum`` plus ``quantile`` samples from the reservoir).
- ``snapshot_doc()``: ONE JSON document of metrics, spans, request
  timelines, flight digests and process identity; what the cross-rank
  aggregation pushes through a store (``aggregate.py``).
- ``chrome_trace()``: ``chrome://tracing`` JSON of the span ring, with
  one named row per request (its lifecycle events as instants, and every
  span stamped with its ``rids`` mirrored onto it).
- ``PeriodicExporter``: a daemon thread that writes ``snapshot_doc()``
  to ``FLAGS_telemetry_export_path`` (or stdout) every
  ``FLAGS_telemetry_export_interval`` seconds. Started by
  ``maybe_start_exporter()``, never while telemetry is off, and stopped
  cleanly (event-signalled, joined with a timeout, a final flush).

The document schemas are the JAX package's, so its readers
(``collect_fleet``, ``format_fleet``) read the port's documents and the
other way round.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import zlib

from ..flags import flag_value
from .flight import flight
from .registry import enabled
from .registry import snapshot as metrics_snapshot
from .requests import snapshot_requests
from .tracer import snapshot_spans

__all__ = [
    "prometheus_text", "snapshot_doc", "chrome_trace",
    "write_chrome_trace", "PeriodicExporter", "maybe_start_exporter",
    "stop_exporter",
]


def _prom_labels(labels: dict, extra: dict | None = None) -> str:
    items = dict(labels or {})
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(items.items()))
    return "{" + body + "}"


def prometheus_text(snap: dict | None = None) -> str:
    """Render a metrics snapshot in the Prometheus text exposition
    format (version 0.0.4). Deterministic: families and series are
    already sorted by the registry snapshot."""
    if snap is None:
        snap = metrics_snapshot()
    lines: list[str] = []
    for name, fam in snap.items():
        kind = fam["type"]
        prom_kind = "summary" if kind == "histogram" else kind
        lines.append(f"# TYPE {name} {prom_kind}")
        for s in fam["samples"]:
            labels = s.get("labels") or {}
            if kind == "histogram":
                for q, key in (("0.5", "p50"), ("0.95", "p95"),
                               ("0.99", "p99")):
                    v = s.get(key)
                    if v is not None:
                        lines.append(
                            f"{name}"
                            f"{_prom_labels(labels, {'quantile': q})}"
                            f" {float(v):g}")
                lines.append(
                    f"{name}_sum{_prom_labels(labels)}"
                    f" {float(s['sum']):g}")
                lines.append(
                    f"{name}_count{_prom_labels(labels)} {int(s['count'])}")
            else:
                lines.append(
                    f"{name}{_prom_labels(labels)} {float(s['value']):g}")
    return "\n".join(lines) + ("\n" if lines else "")


def snapshot_doc() -> dict:
    """The one-document view: metrics + spans + per-request timelines
    + flight-recorder digests + who produced them."""
    fr = flight()
    return {
        "schema": "paddle_tpu.telemetry/1",
        "pid": os.getpid(),
        "rank": int(os.environ.get("PADDLE_TRAINER_ID", "0")),
        "metrics": metrics_snapshot(),
        "spans": snapshot_spans(),
        "requests": snapshot_requests(),
        "flight": {"digests": fr.snapshot(), "dumps": fr.dumps,
                   "dropped": fr.dropped},
    }


def _record_event_spans() -> list[dict]:
    """The profiler's RecordEvent rows. The JAX package merges its
    ``profiler/record_event.py`` host buffer into the trace here; the
    port has no ``profiler`` package yet, so there are no such rows and
    ``include_record_events`` adds nothing."""
    return []


# per-request rows sit far above real thread ids so the two namespaces
# can never collide (thread ids are masked to 31 bits by the tracer)
_REQUEST_TID_BASE = 0x80000000


def request_tid(rid) -> int:
    try:
        return _REQUEST_TID_BASE + int(rid)
    except (TypeError, ValueError):
        # offline documents are caller-supplied JSON; a non-numeric
        # rid still gets a stable (run-independent) row above the
        # thread-id namespace
        return _REQUEST_TID_BASE + (
            zlib.crc32(str(rid).encode()) & 0x7FFFFFFF)


def _rid_sort_key(rid) -> tuple:
    try:
        return (0, int(rid), "")
    except (TypeError, ValueError):
        return (1, 0, str(rid))


def _request_rows(requests: dict, pid: int) -> list[dict]:
    """Render per-request timelines as their own chrome rows: one
    named ``tid`` per request carrying instant events ("i") for every
    lifecycle event. Request event times are ``robustness.now_s``
    (time.monotonic) seconds; span times are ``perf_counter_ns`` — on
    Linux both read CLOCK_MONOTONIC, so the rows line up with the
    engine-step spans on one timeline."""
    rows = []
    for rid_s in sorted(requests, key=_rid_sort_key):
        tid = request_tid(rid_s)
        rows.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "ts": 0.0, "dur": 0.0,
                     "args": {"name": f"request {rid_s}"}})
        entry = requests[rid_s] or {}
        for ev in entry.get("events", []):
            attrs = {k: v for k, v in ev.items()
                     if k not in ("t_s", "kind")}
            rows.append({"ph": "i", "s": "t", "pid": pid, "tid": tid,
                         "ts": float(ev.get("t_s", 0.0)) * 1e6,
                         "dur": 0.0, "name": str(ev.get("kind", "?")),
                         "cat": "Request", "args": attrs})
    return rows


def chrome_trace(spans: list[dict] | None = None, *,
                 include_record_events: bool = True,
                 requests: dict | None = None) -> dict:
    """Build a ``chrome://tracing``-loadable dict. Every event carries
    the required ``ph``/``ts``/``pid``/``tid`` keys (complete "X"
    events, durations in microseconds). Per-request timelines render
    as their own named ``tid`` rows, and any span stamped with a
    ``rids`` attr (serving prefill/decode/sample) is mirrored onto
    each of its requests' rows — so one row shows everything that
    happened to request N. Pass ``requests={}`` to suppress the rows
    (e.g. rendering a document that has none)."""
    events = list(spans if spans is not None else snapshot_spans())
    if include_record_events:
        events.extend(_record_event_spans())
    if requests is None:
        requests = snapshot_requests()
    pid = os.getpid()
    out = []
    for ev in events:
        e = {"ph": "X", "pid": pid, "tid": 0, "dur": 0.0}
        e.update(ev)
        e["ts"] = float(e.get("ts", 0.0))
        out.append(e)
        rids = (ev.get("args") or {}).get("rids")
        if rids and requests:
            for rid in rids:
                if str(rid) in requests or rid in requests:
                    mirrored = dict(e)
                    mirrored["tid"] = request_tid(rid)
                    out.append(mirrored)
    out.extend(_request_rows(requests, pid))
    out.sort(key=lambda e: e["ts"])
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, **kw) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(**kw), f)
    return path


class PeriodicExporter:
    """Background snapshot writer with clean shutdown.

    Writes ``snapshot_doc()`` as one JSON document per tick —
    atomically replaced at ``path`` (tmp + rename) so a reader never
    sees a torn file — or one JSON line per tick on stdout when no path
    is configured. ``stop()`` signals the event, joins the thread and
    writes a final snapshot, so the last events of a run are never
    lost to the interval."""

    def __init__(self, interval: float, path: str = ""):
        self.interval = max(0.05, float(interval))
        self.path = path
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.ticks = 0

    def _write(self) -> None:
        doc = snapshot_doc()
        if self.path:
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                # default=str: span attrs are caller-supplied (np
                # scalars, paths, enums) — a non-JSON attr must degrade
                # to its repr, never kill the exporter thread
                json.dump(doc, f, indent=1, default=str)
            os.replace(tmp, self.path)
        else:
            sys.stdout.write(json.dumps(doc, default=str) + "\n")
            sys.stdout.flush()
        self.ticks += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._write()
            except Exception as e:
                # a failed tick (disk full, torn fs, exotic snapshot
                # content) must not silently end periodic export for
                # the rest of the run — report and keep ticking
                from ..distributed.watchdog import report_degraded
                report_degraded("telemetry.exporter.write", e)

    def start(self) -> "PeriodicExporter":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="paddle-tpu-telemetry-exporter")
            self._thread.start()
        return self

    def stop(self, flush: bool = True) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            self._thread = None
        if flush:
            try:
                self._write()
            except Exception as e:
                from ..distributed.watchdog import report_degraded
                report_degraded("telemetry.exporter.final_flush", e)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()


_EXPORTER: PeriodicExporter | None = None
_EXPORTER_LOCK = threading.Lock()
_ATEXIT_WIRED = False


def maybe_start_exporter() -> PeriodicExporter | None:
    """Start the process's periodic exporter iff telemetry is on AND
    ``FLAGS_telemetry_export_interval`` > 0. Idempotent; returns the
    exporter (or None when gated off). With ``FLAGS_telemetry`` off
    this is a pure no-op — no thread is ever started."""
    global _EXPORTER
    if not enabled():
        return None
    interval = float(flag_value("telemetry_export_interval"))
    if interval <= 0:
        return None
    global _ATEXIT_WIRED
    with _EXPORTER_LOCK:
        if _EXPORTER is None or not _EXPORTER.running:
            _EXPORTER = PeriodicExporter(
                interval, str(flag_value("telemetry_export_path"))).start()
            if not _ATEXIT_WIRED:
                # the thread is a daemon (must never block exit), so the
                # promised final flush has to be explicit: without this
                # the last up-to-interval seconds — typically the
                # failure that ENDED the run — would be missing from
                # the export
                import atexit
                atexit.register(stop_exporter)
                _ATEXIT_WIRED = True
        return _EXPORTER


def stop_exporter() -> None:
    global _EXPORTER
    with _EXPORTER_LOCK:
        exp, _EXPORTER = _EXPORTER, None
    if exp is not None:
        exp.stop()
