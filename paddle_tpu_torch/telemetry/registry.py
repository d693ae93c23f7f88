"""Process-wide metric registry (port of ``telemetry/registry.py``):
Counter / Gauge / Histogram with labels.

One registry per process, three metric kinds, one switch. The serving
metrics (``serving/metrics.py``), the degraded-path reports
(``distributed/watchdog.report_degraded``) and the fault registry
(``distributed/fault.py``) publish through here, so one snapshot answers
"what is this process doing".

- Pure stdlib (no torch, no numpy): the watchdog and the fault registry
  import it, and it adds nothing to the dispatch path.
- OFF by default, and a guarded no-op when off: ``FLAGS_telemetry``
  gates the module-level helpers (``counter()``/``gauge()``/
  ``histogram()``); with the flag off they return a shared inert
  ``_NullMetric`` whose ``inc``/``set``/``observe`` do nothing and
  retain nothing. The check is one registry-dict lookup
  (``flag_value``), no lock. Handles fetched while disabled stay inert,
  so the call-site idiom is ``counter(name).inc()`` per event, never a
  cached handle.
- Creating a metric takes the registry lock once per (name, labels)
  pair; an update takes only the metric's own lock.
- Metric NAMES are literal snake_case strings at the call site and label
  VALUES are dynamic, so the namespace stays greppable and the
  Prometheus page never grows a family per request. Counters end in
  ``_total``; histograms end in a unit (``_seconds``/``_bytes``/
  ``_tokens``/``_ratio``).

Names, labels, snapshot layout and reservoir seeds are the JAX
package's, so the two packages' snapshots of the same events are equal.
"""

from __future__ import annotations

import threading

from ..flags import flag_value

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry",
    "counter", "gauge", "histogram", "enabled", "registry",
    "snapshot", "reset",
]


def enabled() -> bool:
    """One dict lookup — the hot-path guard every helper uses."""
    return bool(flag_value("telemetry"))


def _label_key(labels: dict | None) -> tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Shared plumbing: identity + per-metric lock."""

    kind = "metric"
    __slots__ = ("name", "labels", "_lock")

    def __init__(self, name: str, labels: dict | None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonic event count."""

    kind = "counter"
    __slots__ = ("_value",)

    def __init__(self, name, labels=None):
        super().__init__(name, labels)
        self._value = 0

    def inc(self, n: int | float = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def sample(self) -> dict:
        return {"labels": self.labels, "value": self._value}


class Gauge(_Metric):
    """Last-written instantaneous value."""

    kind = "gauge"
    __slots__ = ("_value",)

    def __init__(self, name, labels=None):
        super().__init__(name, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, delta: float) -> None:
        with self._lock:
            self._value += float(delta)

    @property
    def value(self):
        return self._value

    def sample(self) -> dict:
        return {"labels": self.labels, "value": self._value}


class Reservoir:
    """Fixed-size uniform sample (Vitter's Algorithm R) with EXACT
    count/sum/min/max.

    The first ``capacity`` observations are kept verbatim; after that,
    observation ``i`` replaces a random kept slot with probability
    ``capacity / i`` — every observation ever made has equal probability
    of being in the sample, so percentiles over the sample estimate the
    true distribution while memory stays flat forever. Counts and sums
    are tracked outside the sample and are exact. Replacement slots come
    from a PRIVATE seeded generator: deterministic under test and immune
    to (and invisible to) the process-global ``random`` stream.
    """

    __slots__ = ("capacity", "samples", "count", "total",
                 "min", "max", "_rng")

    def __init__(self, capacity: int, seed: int = 0):
        import random
        self.capacity = max(1, int(capacity))
        self.samples: list[float] = []
        self.count = 0
        self.total = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._rng = random.Random(0xA11CE ^ seed)

    def add(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.total += x
        if self.min is None or x < self.min:
            self.min = x
        if self.max is None or x > self.max:
            self.max = x
        if len(self.samples) < self.capacity:
            self.samples.append(x)
        else:
            j = self._rng.randrange(self.count)
            if j < self.capacity:
                self.samples[j] = x

    def percentile(self, q: float) -> float | None:
        """Nearest-rank percentile over the retained sample (q in 0..100)."""
        if not self.samples:
            return None
        srt = sorted(self.samples)
        idx = min(len(srt) - 1, max(0, int(round(q / 100.0 * (len(srt) - 1)))))
        return srt[idx]


class Histogram(_Metric):
    """Distribution summary: exact count/sum, reservoir percentiles.

    Capacity comes from ``FLAGS_telemetry_reservoir`` at creation time;
    a serving process alive for days keeps a flat-memory sample while
    the count/sum stay exact.
    """

    kind = "histogram"
    __slots__ = ("_res",)

    def __init__(self, name, labels=None, capacity=None):
        super().__init__(name, labels)
        if capacity is None:
            capacity = int(flag_value("telemetry_reservoir"))
        self._res = Reservoir(capacity, seed=len(name))

    def observe(self, v: float) -> None:
        with self._lock:
            self._res.add(v)

    @property
    def count(self):
        return self._res.count

    @property
    def total(self):
        return self._res.total

    def percentile(self, q: float):
        with self._lock:
            return self._res.percentile(q)

    def sample(self) -> dict:
        with self._lock:
            r = self._res
            return {"labels": self.labels, "count": r.count,
                    "sum": r.total, "min": r.min, "max": r.max,
                    "p50": r.percentile(50), "p95": r.percentile(95),
                    "p99": r.percentile(99)}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricRegistry:
    """All metric families of one process, keyed by (name, label set)."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"kind": str, "series": {label_key: metric}}
        self._families: dict[str, dict] = {}

    def get(self, kind: str, name: str, labels: dict | None = None):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = {"kind": kind, "series": {}}
                self._families[name] = fam
            elif fam["kind"] != kind:
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{fam['kind']}, requested {kind}")
            metric = fam["series"].get(key)
            if metric is None:
                metric = _KINDS[kind](name, labels)
                fam["series"][key] = metric
            return metric

    def snapshot(self) -> dict:
        """{name: {"type": kind, "samples": [sample, ...]}} — families
        are sorted by name, series by label key, so two snapshots of the
        same state serialize identically."""
        with self._lock:
            fams = {n: (f["kind"], list(f["series"].items()))
                    for n, f in self._families.items()}
        out = {}
        for name in sorted(fams):
            kind, series = fams[name]
            out[name] = {"type": kind,
                         "samples": [m.sample()
                                     for _, m in sorted(series)]}
        return out

    def reset(self) -> None:
        with self._lock:
            self._families.clear()


_REGISTRY = MetricRegistry()


class _NullMetric:
    """Inert stand-in handed out while FLAGS_telemetry is off: every
    update is a no-op and nothing is ever retained."""

    __slots__ = ()
    kind = "null"
    name = ""
    labels: dict = {}
    value = 0
    count = 0
    total = 0.0

    def inc(self, n=1):
        pass

    def set(self, v):
        pass

    def add(self, delta):
        pass

    def observe(self, v):
        pass

    def percentile(self, q):
        return None

    def sample(self):
        return {"labels": {}, "value": 0}


_NULL = _NullMetric()


def registry() -> MetricRegistry:
    return _REGISTRY


def counter(name: str, labels: dict | None = None):
    """The per-event idiom: ``counter("x_total", labels={...}).inc()``."""
    if not enabled():
        return _NULL
    return _REGISTRY.get("counter", name, labels)


def gauge(name: str, labels: dict | None = None):
    if not enabled():
        return _NULL
    return _REGISTRY.get("gauge", name, labels)


def histogram(name: str, labels: dict | None = None):
    if not enabled():
        return _NULL
    return _REGISTRY.get("histogram", name, labels)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


def reset() -> None:
    _REGISTRY.reset()
