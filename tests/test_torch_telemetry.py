"""The telemetry package of the PyTorch port and serving's observability,
against the JAX package.

- Units, from tests/test_telemetry.py's cases, run on both packages with
  the same calls: counters, gauges, histograms and labels; the
  reservoir's flat memory; the span ring's bound and its capacity
  following ``set_flags``; ``timed``; the Prometheus text; the Chrome
  trace (valid, read twice, per-request rows); the periodic exporter
  (writes, stops, survives attributes it cannot serialise); the flight
  ring (bound, newest kept, follows ``set_flags``, atomic dump into a
  directory, dump on DEGRADED entry); the request log (the event bound
  keeps the terminal event, the oldest-started timeline is evicted); the
  off switch (no samples, no spans, no thread). Each case's results are
  equal across the packages.
- ``ServingMetrics`` driven by the same calls in both packages: the
  goodput ledger, the SLO checks, the decode roofline, the
  attention-bytes ledger, every family and ``snapshot()``.
- Aggregation across the packages: either package's ``push_snapshot``
  into one store, read by either package's ``collect_fleet`` and
  ``format_fleet``; a corrupt rank is skipped and counted.
- ``report_degraded`` and ``fault_injected_total``: the same counter
  series for the same sites and fault specs.
- The engine with telemetry on, against the JAX engine, on one fake
  clock: the default engine with the prefix cache, ``spec="ngram"``, and
  the host tier with one ``serving.decode:times=1`` fault. Tokens, every
  counter series, histogram counts, gauges, ``metrics.snapshot()``, the
  spans (but their timestamps), the flight digests (but ``dur_s`` and
  ``kernel``), the step-failure dump and the request timelines are equal.
- The goodput ledger's contract (tests/test_serving_robustness.py): it
  sums to the tokens computed, a preempted re-prefill books under
  ``preempt_reprefill``, an expired partial under ``expired_partial``.
- The request handoff across the packages, both ways, mid-decode and
  mid-prefill (tests/test_disagg.py): the moved requests' tokens, greedy
  and seeded stochastic, equal an unmoved run; what the source books;
  the errors; a draining engine refusing an import.
- ``routing_signals`` and ``enable_fleet_publish`` against the JAX
  engine's.

Everything runs on the CPU with one-layer models. The JAX engines run
their plain paged attention and share one jitted step and one pool size,
so each signature compiles once.
"""

import contextlib
import json
import logging
import threading
from types import SimpleNamespace

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as pt
from paddle_tpu import telemetry as jtel
from paddle_tpu.distributed import fault as jfault
from paddle_tpu.distributed import watchdog as jwatchdog
from paddle_tpu.serving import RequestRejected as JRequestRejected
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import engine as jengine_mod
from paddle_tpu.serving import metrics as jmetrics_mod
from paddle_tpu.serving import robustness as jrob
from paddle_tpu.serving import scheduler as jsched_mod
from paddle_tpu_torch import ServingEngine
from paddle_tpu_torch import telemetry as ttel
from paddle_tpu_torch.distributed import fault as tfault
from paddle_tpu_torch.distributed import watchdog as twatchdog
from paddle_tpu_torch.serving import RequestRejected
from paddle_tpu_torch.serving import engine as tengine_mod
from paddle_tpu_torch.serving import metrics as tmetrics_mod
from paddle_tpu_torch.serving import robustness as trob
from paddle_tpu_torch.serving import scheduler as tsched_mod
from test_torch_serving_prefix_spec import (_cycling_prompts, _pair,
                                            _zipf_prompts)
from test_torch_serving_tier_robustness import (FAULT_CALLS, FAULT_SPECS,
                                                Clock, flags)
from torch_threads import one_torch_thread  # noqa: F401

JAX = SimpleNamespace(name="jax", tel=jtel, metrics=jmetrics_mod, rob=jrob,
                      sched=jsched_mod, watchdog=jwatchdog, fault=jfault,
                      Rejected=JRequestRejected)
PORT = SimpleNamespace(name="port", tel=ttel, metrics=tmetrics_mod,
                       rob=trob, sched=tsched_mod, watchdog=twatchdog,
                       fault=tfault, Rejected=RequestRejected)
PKGS = (JAX, PORT)
EXPORTER_THREAD = "paddle-tpu-telemetry-exporter"


@contextlib.contextmanager
def telemetry_on(**kw):
    """Telemetry on in both packages (with any other flags), clean state
    before and after, and no exporter left running."""
    with flags(telemetry=True, **kw):
        for p in PKGS:
            p.tel.reset_all()
        try:
            yield
        finally:
            for p in PKGS:
                p.tel.stop_exporter()
                p.tel.reset_all()


@pytest.fixture(autouse=True)
def _telemetry():
    with telemetry_on():
        yield


@pytest.fixture(scope="module", autouse=True)
def _jax_plain_attention():
    """The JAX side runs its plain paged attention; module-scoped, so the
    module-scoped runs below see it."""
    before = pt.get_flags("serving_paged_kernel")["serving_paged_kernel"]
    pt.set_flags({"serving_paged_kernel": "reference"})
    yield
    pt.set_flags({"serving_paged_kernel": before})


class FakeStore(dict):
    """The ``set``/``get`` surface of a TCPStore, counting writes."""

    def __init__(self, epoch=None):
        super().__init__()
        self.sets = 0
        if epoch is not None:
            self.epoch = epoch

    def set(self, k, v):
        self.sets += 1
        self[k] = v

    def get(self, k, default=None):
        return dict.get(self, k, default)


def _spans(spans):
    """Spans without their clock and thread: (name, cat, args)."""
    return [(s["name"], s["cat"], s.get("args")) for s in spans]


def _counter(snap, name, **labels):
    for s in snap.get(name, {}).get("samples", []):
        if s["labels"] == {k: str(v) for k, v in labels.items()}:
            return s["value"]
    return None


# ---------------------------------------------------------------------------
# (a) units, from tests/test_telemetry.py, on both packages
# ---------------------------------------------------------------------------

def u_counters(p, tmp):
    t = p.tel
    t.counter("req_total").inc()
    t.counter("req_total").inc(2)
    t.counter("req_total", labels={"site": "a"}).inc()
    t.gauge("depth").set(3)
    t.gauge("depth").set(5)
    t.gauge("depth", labels={"q": 1}).add(2.5)
    h = t.histogram("lat_seconds")
    for v in (0.1, 0.2, 0.3, 0.4):
        h.observe(v)
    with pytest.raises(TypeError):
        t.gauge("req_total")
    snap = t.snapshot()
    assert _counter(snap, "req_total") == 3
    assert _counter(snap, "req_total", site="a") == 1
    hs = snap["lat_seconds"]["samples"][0]
    assert hs["count"] == 4 and hs["min"] == pytest.approx(0.1)
    return snap


def u_reservoir(p, tmp):
    h = p.tel.histogram("big_seconds")
    for i in range(10_000):
        h.observe(i / 1000.0)
    s = p.tel.snapshot()["big_seconds"]["samples"][0]
    assert s["count"] == 10_000 and len(h._res.samples) <= 64
    assert s["p50"] == pytest.approx(5.0, rel=0.35)
    return s, list(h._res.samples)


def u_span_ring(p, tmp):
    p.tel.reset_spans(capacity=8)
    for i in range(50):
        with p.tel.span("loop/iter", step=i):
            pass
    spans = p.tel.snapshot_spans()
    assert [s["args"]["step"] for s in spans] == list(range(42, 50))
    assert p.tel.tracer().dropped == 42
    return _spans(spans)


def u_span_ring_follows_flags(p, tmp):
    for i in range(10):
        with p.tel.span("loop/iter", step=i):
            pass
    spans = p.tel.snapshot_spans()
    assert [s["args"]["step"] for s in spans] == [6, 7, 8, 9]
    return _spans(spans)


def u_span_attribution(p, tmp):
    with p.tel.span("serving/engine_step", cat="Serving", step=7, slots=3):
        pass
    (ev,) = p.tel.snapshot_spans()
    assert ev["tid"] == threading.get_ident() & 0x7FFFFFFF
    assert ev["dur"] >= 0.0 and sorted(ev) == ["args", "cat", "dur", "name",
                                               "tid", "ts"]
    drained = p.tel.drain_spans()
    assert len(drained) == 1 and p.tel.snapshot_spans() == []
    return _spans([ev])


def u_timed(p, tmp):
    with p.tel.timed("ckpt/save", "save_seconds", step=3,
                     labels={"kind": "full"}):
        pass
    s = p.tel.snapshot()["save_seconds"]["samples"][0]
    assert s["count"] == 1 and s["labels"] == {"kind": "full"}
    return _spans(p.tel.snapshot_spans())


def _parse_prometheus(text):
    """Minimal exposition parser: {(name, labels): value} and types."""
    types, values = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            types[name] = kind
            continue
        assert line and not line.startswith("#"), line
        body, val = line.rsplit(" ", 1)
        name, labels = body, ()
        if "{" in body:
            name, rest = body.split("{", 1)
            assert rest.endswith("}")
            labels = tuple(sorted(tuple(x.split("=", 1))
                                  for x in rest[:-1].split(",")))
        values[(name, labels)] = float(val)
    return types, values


def u_prometheus(p, tmp):
    t = p.tel
    t.counter("req_total").inc(5)
    t.counter("deg_total", labels={"site": 'a"b\\c'}).inc(2)
    t.gauge("depth").set(3.5)
    h = t.histogram("lat_seconds")
    for v in range(100):
        h.observe(v / 100.0)
    text = t.prometheus_text()
    types, values = _parse_prometheus(text)
    assert types == {"req_total": "counter", "deg_total": "counter",
                     "depth": "gauge", "lat_seconds": "summary"}
    assert values[("lat_seconds_count", ())] == 100
    assert values[("lat_seconds_sum", ())] == pytest.approx(49.5)
    return text


def u_chrome_trace(p, tmp):
    t = p.tel
    t.begin_request(7)
    t.record_request_event(7, {"t_s": 1.0, "kind": "arrival",
                               "prompt_len": 4})
    t.record_request_event(7, {"t_s": 2.0, "kind": "terminal",
                               "outcome": "ok"}, final=True)
    with t.span("serving/decode", cat="Serving", step=3, rids=[7]):
        pass
    with t.span("serving/engine_step", cat="Serving", step=3):
        pass
    first = json.loads(json.dumps(t.chrome_trace()))
    trace = t.chrome_trace(include_record_events=True)
    assert len(trace["traceEvents"]) == len(first["traceEvents"])
    evs = trace["traceEvents"]
    assert all({"ph", "ts", "pid", "tid"} <= set(e) for e in evs)
    assert [e["ts"] for e in evs] == sorted(e["ts"] for e in evs)
    tid = t.request_tid(7)
    rows = [(e["ph"], e["name"], e["tid"] == tid, e.get("args"))
            for e in evs]
    assert rows.count(("X", "serving/decode", True,
                       {"rids": [7], "step": 3})) == 1
    assert t.request_tid("x") == t.request_tid("x") > 0x80000000
    return rows, t.write_chrome_trace(str(tmp / "trace.json")) and len(
        json.loads((tmp / "trace.json").read_text())["traceEvents"])


def _wait_ticks(exp):
    for _ in range(500):
        if exp.ticks:
            return
        threading.Event().wait(0.01)


def u_exporter(p, tmp):
    t = p.tel
    t.counter("tick_total").inc()
    with t.span("bad/attrs", arr=np.int64(3), obj=object()):
        pass
    exp = t.maybe_start_exporter()
    assert exp is not None and exp.running
    assert t.maybe_start_exporter() is exp
    _wait_ticks(exp)
    assert exp.ticks > 0 and exp.running
    t.stop_exporter()
    assert not exp.running
    assert EXPORTER_THREAD not in {x.name for x in threading.enumerate()}
    doc = json.loads((tmp / "snap.json").read_text())
    (ev,) = [s for s in doc["spans"] if s["name"] == "bad/attrs"]
    assert ev["args"]["arr"] == "3"
    assert not list(tmp.glob("*.tmp.*"))
    return doc["schema"], doc["metrics"], sorted(doc)


def u_flight_ring(p, tmp):
    for i in range(20):
        p.tel.record_flight_step(step=i, src="test")
    digests = p.tel.flight().snapshot()
    assert [d["step"] for d in digests] == list(range(12, 20))
    assert p.tel.flight().dropped == 12
    return digests, p.tel.format_flight(digests)


def u_flight_follows_flags(p, tmp):
    for i in range(5):
        p.tel.record_flight_step(step=i)
    with flags(telemetry_flight_steps=3):
        p.tel.record_flight_step(step=5)
        digests = p.tel.flight().snapshot()
    assert [d["step"] for d in digests] == [3, 4, 5]
    return digests, p.tel.flight().dropped


def u_flight_dump_dir(p, tmp):
    with flags(telemetry_flight_dir=str(tmp)):
        p.tel.record_flight_step(step=1, src="test", dur_s=0.5)
        doc = p.tel.dump_flight("drain", health={"state": "stopped"},
                                extra={"drained": 2})
    path = tmp / "flight-001-drain.json"
    assert p.tel.flight().last_dump_path == str(path)
    assert p.tel.flight().dump_for("drain") is doc
    on_disk = json.loads(path.read_text())
    assert not list(tmp.glob("*.tmp.*"))
    assert on_disk == json.loads(json.dumps(doc))
    return on_disk, p.tel.snapshot()


def u_flight_dump_unwritable(p, tmp):
    """A flight dump that cannot be written is reported, not raised."""
    (tmp / "file").write_text("")
    with flags(telemetry_flight_dir=str(tmp / "file")):
        doc = p.tel.dump_flight("degraded", health={})
    assert doc is not None and p.tel.flight().last_dump_path is None
    return p.tel.snapshot()


class _StubEngine:
    """What robustness' failure handlers touch: real ServingMetrics and
    Lifecycle, no device."""

    def __init__(self, p):
        self.metrics = p.metrics.ServingMetrics()
        self.lifecycle = p.rob.Lifecycle()

    def health(self):
        return {"state": self.lifecycle.state,
                "degraded_reason": self.lifecycle.degraded_reason}


def u_flight_dump_on_degraded(p, tmp):
    eng = _StubEngine(p)
    p.tel.record_flight_step(step=0, src="test")
    p.rob.handle_schedule_failure(eng, ConnectionError("store blip"))
    doc = p.tel.flight().dump_for("degraded")
    assert doc["health"]["state"] == "degraded"
    assert doc["extra"]["phase"] == "schedule"
    p.rob.handle_schedule_failure(eng, ConnectionError("again"))
    assert p.tel.flight().dumps == 1
    return {k: v for k, v in doc.items() if k != "pid"}, p.tel.snapshot()


def u_request_event_bound(p, tmp):
    with flags(telemetry_request_events_max=4):
        p.tel.begin_request(7)
        for i in range(10):
            p.tel.record_request_event(7, {"t_s": float(i), "kind": "ev",
                                           "i": i})
        p.tel.record_request_event(7, {"t_s": 99.0, "kind": "terminal"},
                                   final=True)
        seq = p.sched.Sequence(3, [1, 2, 3], max_new_tokens=4)
        for i in range(6):
            p.rob.note_event(seq, "ev", t_s=float(i))
        p.rob.note_event(seq, "terminal", t_s=9.0)
    tl = p.tel.request_timeline(7)
    assert [e["kind"] for e in tl["events"]] == ["ev"] * 3 + ["terminal"]
    assert tl["dropped"] == 7
    assert [e["kind"] for e in seq.events] == ["ev"] * 3 + ["terminal"]
    assert seq.events_dropped == 3
    return tl, seq.events, p.tel.format_request_timeline(7, tl)


def u_request_log_evicts(p, tmp):
    with flags(telemetry_requests_max=3):
        for rid in range(5):
            p.tel.begin_request(rid)
            p.tel.record_request_event(rid, {"t_s": 0.0, "kind": "arrival"})
    assert sorted(p.tel.snapshot_requests()) == ["2", "3", "4"]
    assert p.tel.request_log().evicted == 2
    assert p.tel.request_timeline(0) is None
    return p.tel.snapshot_requests()


def u_off_switch_inert(p, tmp):
    t = p.tel
    with flags(telemetry=False, telemetry_export_interval=0.05):
        t.reset_all()
        t.counter("anything_total").inc(100)
        t.gauge("depth").set(9)
        t.histogram("lat_seconds").observe(1.0)
        with t.span("some/span"):
            pass
        with t.timed("some/span", "lat_seconds"):
            pass
        t.record_span("x", 0, 10)
        t.record_flight_step(step=0)
        t.declare_defaults()
        seq = p.sched.Sequence(0, [1, 2, 3], max_new_tokens=4)
        p.rob.note_event(seq, "arrival")
        p.rob.note_event(seq, "terminal", outcome="ok")
        out = (t.snapshot(), t.snapshot_spans(), t.flight().snapshot(),
               t.dump_flight("degraded", health={}), t.snapshot_requests(),
               t.maybe_start_exporter(), seq.events, seq.events_dropped,
               t.counter("anything_total").value)
    assert EXPORTER_THREAD not in {x.name for x in threading.enumerate()}
    assert out == ({}, [], [], None, {}, None, [], 0, 0)
    return out


def u_declare_defaults(p, tmp):
    p.tel.declare_defaults()
    return p.tel.snapshot()


def u_serving_metrics_reservoir(p, tmp):
    cap = 512
    m = p.metrics.ServingMetrics()
    n = 4 * cap
    for i in range(n):
        m.on_arrival()
        m.on_first_token(0.001 * (i % 100))
        m.on_token()
        m.on_token_gap(0.002)
        m.on_finish()
    assert m.ttft_s.count == n and len(m.ttft_s.samples) <= cap
    snap = m.snapshot()
    m.snapshot(reset=True)
    assert m.ttft_s.count == 0 and not m.ttft_s.samples
    return snap, p.tel.snapshot()


# name -> (case, flags for both packages)
UNITS = {
    "counters_gauges_histograms_labels": (u_counters, {}),
    "reservoir_memory_flat": (u_reservoir, dict(telemetry_reservoir=64)),
    "span_ring_bounded": (u_span_ring, {}),
    "span_ring_follows_set_flags": (u_span_ring_follows_flags,
                                    dict(telemetry_spans_max=4)),
    "span_attribution": (u_span_attribution, {}),
    "timed": (u_timed, {}),
    "prometheus_text": (u_prometheus, {}),
    "chrome_trace_rows_non_destructive": (u_chrome_trace, {}),
    "exporter_writes_stops_survives_attrs": (
        u_exporter, dict(telemetry_export_interval=0.05)),
    "flight_ring_bound_newest_kept": (u_flight_ring,
                                      dict(telemetry_flight_steps=8)),
    "flight_ring_follows_set_flags": (u_flight_follows_flags, {}),
    "flight_dump_atomic_into_dir": (u_flight_dump_dir, {}),
    "flight_dump_unwritable_dir_reported": (u_flight_dump_unwritable, {}),
    "flight_dump_on_degraded_entry": (u_flight_dump_on_degraded, {}),
    "request_event_bound_keeps_terminal": (u_request_event_bound, {}),
    "request_log_evicts_oldest_started": (u_request_log_evicts, {}),
    "off_switch_inert": (u_off_switch_inert, {}),
    "declare_defaults": (u_declare_defaults, {}),
    "serving_metrics_reservoir_flat": (u_serving_metrics_reservoir, {}),
}


@pytest.mark.parametrize("name", list(UNITS))
def test_telemetry_unit_matches_jax(name, tmp_path):
    """Each case holds its contract in both packages, and the two
    packages' results are equal."""
    case, kw = UNITS[name]
    out = []
    for p in PKGS:
        tmp = tmp_path / p.name
        tmp.mkdir()
        extra = dict(kw)
        if case is u_exporter:
            extra["telemetry_export_path"] = str(tmp / "snap.json")
        with telemetry_on(**extra):
            out.append(case(p, tmp))
    assert out[1] == out[0]


def test_import_starts_no_thread_and_schema_is_shared():
    """The port's documents carry the JAX package's schema names, so
    either package's readers take them."""
    assert ttel.snapshot_doc()["schema"] == jtel.snapshot_doc()["schema"]
    assert (ttel.dump_flight("drain")["schema"]
            == jtel.dump_flight("drain")["schema"])
    assert ttel.merge_docs({})["schema"] == jtel.merge_docs({})["schema"]
    assert EXPORTER_THREAD not in {x.name for x in threading.enumerate()}


# ---------------------------------------------------------------------------
# (b) ServingMetrics, call by call
# ---------------------------------------------------------------------------

def _metrics_script(p):
    """The same ServingMetrics calls in either package: rewinds of both
    causes, speculation, every terminal outcome, a handoff, the roofline,
    attention bytes, the SLO checks, the pool syncs and the step
    gauges."""
    m = p.metrics.ServingMetrics()
    seqs = [p.sched.Sequence(i, list(range(1, 9)), max_new_tokens=6)
            for i in range(6)]
    a, b, c, d, e, f = seqs
    m.on_arrival()
    m.on_tokens_computed(a, 0, 8)
    m.on_first_token(0.2)
    m.on_first_token(0.7)
    m.on_tokens_computed(a, 8, 1)
    a.rewind_cause = "preempt"
    m.on_tokens_computed(a, 0, 9)
    m.on_tokens_computed(a, 9, 1)
    b.computed_hw = 0
    m.on_tokens_computed(b, 0, 8)
    b.rewind_cause = "retry"
    m.on_tokens_computed(b, 0, 4)
    m.on_spec_tokens(c, 0, 8, 0)
    m.on_spec_tokens(c, 8, 3, 2)
    m.on_spec_verify("ngram", 4, 2)
    m.on_spec_step(2)
    m.on_spec_tokens(d, 0, 5, 3)
    m.on_tokens_computed(e, 0, 8)
    m.on_tokens_computed(f, 0, 6)
    for seq, outcome in ((a, "ok"), (b, "ok"), (c, "ok"), (d, "expired"),
                         (e, "failed")):
        seq.outcome = outcome
        m.on_terminal(outcome)
        m.resolve_ledger(seq)
    m.resolve_handoff(f, fresh_kind=p.metrics.MIGRATED)
    m.on_finish(0.05)
    m.on_finish(0.5)
    m.on_finish()
    m.on_token()
    m.on_token_gap(0.01, 3)
    m.on_decode_roofline(0.25)
    m.on_decode_roofline(0.75)
    m.on_attn_bytes(1000, 4000)
    m.on_prefix(2, 16, 8, 1, cached_blocks=5)
    m.on_prefix(0, 0, 0, 0, cached_blocks=4)
    m.on_host_tier(1, 8, 2, 1, 0, blocks=3, nbytes=3072)
    m.on_phases({"schedule": 0.001, "decode": 0.01})
    m.on_step(decode_slots=2, total_slots=4, queue_depth=3,
              pool_utilization=0.5)
    m.on_shed("queue_full")
    m.on_step_failure("decode")
    m.on_hung_step()
    m.on_preempt()
    snap = m.snapshot()
    return snap, m.snapshot(reset=True), m.snapshot(), p.tel.snapshot()


def test_serving_metrics_match_jax_call_by_call():
    """Equal snapshots and registries for the same calls, with both SLO
    targets set; the ledger's kinds sum to the tokens computed once every
    sequence is resolved, and a reset carries nothing forward then."""
    out = []
    for p in PKGS:
        with telemetry_on(serving_ttft_slo_s=0.5, serving_tpot_slo_s=0.1):
            out.append(_metrics_script(p))
    assert out[1] == out[0]
    snap, _, after, reg = out[1]
    assert sum(snap["token_ledger"].values()) == snap["tokens_computed"]
    assert set(snap["token_ledger"]) == {
        "goodput", "preempt_reprefill", "recompute_replay", "spec_accepted",
        "spec_rejected", "expired_partial", "failed", "migrated"}
    assert snap["slo_missed"] == {"ttft": 1, "tpot": 1}
    assert snap["decode_roofline_frac"] == 0.5
    assert snap["attn_bytes_frac"] == 0.25
    assert after["tokens_computed"] == 0
    assert _counter(reg, "serving_slo_miss_total", slo="ttft") == 1


# ---------------------------------------------------------------------------
# (c) aggregation across the packages
# ---------------------------------------------------------------------------

def _push_two_ranks(p, store):
    t = p.tel
    t.counter("req_total").inc(3)
    t.gauge("depth").set(1.0)
    t.histogram("lat_seconds").observe(0.5)
    t.push_snapshot(store, 0, serving={"state": "serving", "waiting": 1,
                                       "role": "prefill",
                                       "handoffs": {"out": 2, "in": 0}})
    t.counter("req_total").inc(4)
    t.gauge("depth").set(9.0)
    t.histogram("lat_seconds").observe(1.5)
    t.push_snapshot(store, 1)


@pytest.mark.parametrize("reader", ["jax", "port"])
def test_fleet_aggregation_across_packages(reader):
    """Each package pushes two ranks into a store of its own, with a
    corrupt third rank; the reader package collects both stores into
    equal fleet documents, skips the corrupt rank and counts it once per
    store."""
    rd = JAX if reader == "jax" else PORT
    stores = []
    for p in PKGS:
        stores.append(FakeStore(epoch=3))
        _push_two_ranks(p, stores[-1])
        stores[-1].set(p.tel.KEY_PREFIX + "rank2", b"{not json")
    fleets = [rd.tel.collect_fleet(store, 4) for store in stores]
    assert fleets[1] == fleets[0]
    fleet = fleets[1]
    assert fleet["ranks"] == [0, 1] and fleet["absent"] == [2, 3]
    assert fleet["store_epoch"] == 3
    assert fleet["metrics"]["req_total"]["fleet_total"] == 10
    assert fleet["metrics"]["depth"]["max"] == 9.0
    assert fleet["metrics"]["lat_seconds"]["count"] == 3
    assert "role=prefill handoffs_out=2" in rd.tel.format_fleet(fleet)
    assert rd.tel.format_fleet(fleets[0]) == rd.tel.format_fleet(fleets[1])
    assert _counter(rd.tel.snapshot(), "watchdog_degraded_total",
                    site="telemetry.aggregate.decode") == 2


# ---------------------------------------------------------------------------
# (d) report_degraded and fault_injected_total
# ---------------------------------------------------------------------------

DEGRADED_SITES = ["serving.step.decode", "serving.scheduler.pool_exhausted",
                  "store.set('bar/round/3')", "checkpoint.load(step_7)"]


def test_report_degraded_counts_every_report_logs_once(caplog):
    """The same ``watchdog_degraded_total{site}`` series in both packages
    (the site cut at its first '('); the port logs once per site and
    exception type."""
    snaps = []
    with caplog.at_level(logging.WARNING,
                         logger="paddle_tpu_torch.distributed.watchdog"):
        for p in PKGS:
            for i in range(20):
                for site in DEGRADED_SITES:
                    p.watchdog.report_degraded(
                        site.replace("3", str(i)), ValueError("x"))
            snaps.append(p.tel.snapshot())
    assert snaps[1] == snaps[0]
    assert _counter(snaps[1], "watchdog_degraded_total",
                    site="store.set") == 20
    port_lines = [r for r in caplog.records
                  if r.name == "paddle_tpu_torch.distributed.watchdog"]
    assert len(port_lines) == 3 + 20


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_injected_total_matches_jax(spec):
    """The same ``fault_injected_total{site, action}`` series for the same
    spec and calls."""
    snaps = []
    with flags(fault_spec=spec):
        for p in PKGS:
            for site, ctx in FAULT_CALLS:
                try:
                    p.fault.fault_point(site, **ctx)
                except p.fault.FaultInjected:
                    pass
            snaps.append(p.tel.snapshot())
    assert snaps[1] == snaps[0]
    assert snaps[1]["fault_injected_total"]["samples"]


# ---------------------------------------------------------------------------
# (e) the engine with telemetry on, against the JAX engine
# ---------------------------------------------------------------------------

GEOM = dict(num_hidden_layers=1, num_key_value_heads=2,
            max_position_embeddings=96)
KNOBS = dict(block_size=4, max_slots=3, prefill_chunk=8)
# every engine of this module: 24 usable blocks of 4 tokens, so the
# preemption case below preempts and no other case depends on the size
POOL_BLOCKS = 25
CLOCK_MODULES = (jengine_mod, jsched_mod, jrob, tengine_mod, tsched_mod,
                 trob)


@pytest.fixture(scope="module")
def models():
    return _pair(13, **GEOM)


@pytest.fixture(scope="module")
def make(models):
    """``make(**knobs)`` -> (JAX engine, port engine) on the same model;
    the JAX engines share their jitted steps (module docstring)."""
    jm, tm = models
    shared = {}

    def build(**kw):
        kw = dict(KNOBS, pool_blocks=POOL_BLOCKS, **kw)
        jeng = JServingEngine.from_model(jm, **kw)
        for name in ("_step_jit", "_step_full_jit"):
            fn = getattr(jeng, name)
            if fn is not None:
                setattr(jeng, name, shared.setdefault(name, fn))
        return jeng, ServingEngine.from_model(tm, device="cpu", **kw)
    return build


@pytest.fixture(scope="module")
def module_clock():
    c = Clock()
    with pytest.MonkeyPatch.context() as mp:
        for mod in CLOCK_MODULES:
            mp.setattr(mod, "now_s", c)
        yield c


@pytest.fixture
def clock(module_clock):
    module_clock.t, module_clock.tick = 1000.0, 0.0
    return module_clock


def _drive(eng):
    done = {}
    while eng.has_work():
        for seq in eng.step():
            done[seq.req_id] = seq
    return done


def _shared_prompts():
    """Zipf over 2 system prompts of 12 tokens with short suffixes; the
    odd requests sample (seeded)."""
    prompts = _zipf_prompts(np.random.RandomState(3), 6, 2, 12, 4)
    return [(p, dict(max_new_tokens=5, temperature=0.8, top_k=16, seed=i)
             if i % 2 else dict(max_new_tokens=5))
            for i, p in enumerate(prompts)]


def run_default(eng, models):
    reqs = _shared_prompts()
    rids = [eng.add_request(p, **kw) for p, kw in reqs]
    done = _drive(eng)
    return [done[r] for r in rids]


def run_ngram(eng, models):
    prompts = _cycling_prompts(models[1])
    rids = [eng.add_request(p, max_new_tokens=10) for p in prompts]
    done = _drive(eng)
    return [done[r] for r in rids]


def run_hosttier_fault(eng, models):
    seqs = []
    for p, kw in _shared_prompts():
        rid = eng.add_request(p, **kw)
        seqs.append(_drive(eng)[rid])
    eng.drain()
    return seqs


# run -> (scenario, engine knobs, flags for both packages)
RUNS = {
    "default_prefix_cache": (run_default, dict(prefix_cache=True), {}),
    "spec_ngram": (run_ngram, dict(spec="ngram", token_budget=32), {}),
    "host_tier_decode_fault": (
        run_hosttier_fault, dict(prefix_cache=True, host_tier=True),
        dict(serving_prefix_cached_blocks=2,
             fault_spec="serving.decode:times=1")),
}
CLOCKED = ("ttft_p50_s", "ttft_p95_s", "ttft_p99_s", "tpot_p50_s",
           "tpot_p95_s", "tpot_p99_s", "phase_seconds",
           "decode_roofline_frac")
GAUGES = ("serving_goodput_ratio", "serving_health_state",
          "serving_queue_depth", "serving_batch_occupancy",
          "serving_pool_utilization", "serving_prefix_cached_blocks",
          "serving_host_tier_blocks", "serving_host_tier_bytes")


def _observe(p, eng, seqs):
    snap = p.tel.snapshot()
    flight = p.tel.flight()
    return dict(
        tokens=[s.output_ids for s in seqs],
        outcomes=[(s.outcome, s.retries) for s in seqs],
        counters={n: f["samples"] for n, f in snap.items()
                  if f["type"] == "counter"},
        histogram_counts={n: [(s["labels"], s["count"])
                              for s in f["samples"]]
                          for n, f in snap.items()
                          if f["type"] == "histogram"},
        gauges={n: snap[n]["samples"] for n in GAUGES if n in snap},
        snapshot={k: v for k, v in eng.metrics.snapshot().items()
                  if k not in CLOCKED},
        snapshot_keys=sorted(eng.metrics.snapshot()),
        spans=_spans(p.tel.snapshot_spans()),
        flight=[{k: v for k, v in d.items() if k not in ("dur_s", "kernel")}
                for d in flight.snapshot()],
        dumps={t: (d["extra"], len(d["digests"]),
                   d["digests"][-1]["step"] if d["digests"] else None,
                   {k: v for k, v in d["health"].items()
                    if k != "paged_kernel"},
                   sorted(r for r, tl in d["requests"].items()
                          if any(e["kind"] == "retry"
                                 for e in tl["events"])))
               for t in ("degraded", "quarantine", "drain")
               if (d := flight.dump_for(t)) is not None},
        timelines=p.tel.snapshot_requests(),
        seq_events=[s.events for s in seqs],
        kernel={d["kernel"] for d in flight.snapshot()})


@pytest.fixture(scope="module")
def engine_runs(make, models, module_clock):
    out = {}
    for name, (scenario, knobs, kw) in RUNS.items():
        jeng, teng = make(**knobs)
        got = []
        for p, eng in ((JAX, jeng), (PORT, teng)):
            with telemetry_on(**kw):
                p.fault.reset()
                module_clock.t, module_clock.tick = 1000.0, 0.0
                seqs = scenario(eng, models)
                got.append(_observe(p, eng, seqs))
        out[name] = got
    return out


ASPECTS = ("tokens", "counters", "histogram_counts", "gauges", "snapshot",
           "spans", "flight", "dumps", "timelines")


@pytest.mark.parametrize("aspect", ASPECTS)
@pytest.mark.parametrize("run", list(RUNS))
def test_engine_telemetry_matches_jax(engine_runs, run, aspect):
    j, t = engine_runs[run]
    assert t[aspect] == j[aspect]
    if aspect == "snapshot":
        assert t["snapshot_keys"] == j["snapshot_keys"]
    if aspect == "timelines":
        assert t["seq_events"] == j["seq_events"]
    if aspect == "flight":
        assert t["kernel"] == {"plain"} and j["kernel"] == {"reference"}


def test_engine_telemetry_runs_reach_their_contracts(engine_runs):
    """What the equalities above stand on: the counters agree with the
    engine, the ledger is whole, the spans count the steps, and the
    faulted run replayed, dumped and drained."""
    for run, (_, t) in engine_runs.items():
        c, snap = t["counters"], t["snapshot"]
        steps = c["serving_engine_steps_total"][0]["value"]
        assert steps == snap["steps"]
        assert sum(s[0] == "serving/engine_step" for s in t["spans"]) \
            == steps
        assert sum(s["value"] for s in c["serving_tokens_total"]) \
            == snap["tokens_computed"] == sum(snap["token_ledger"].values())
        assert c["serving_requests_total"][0]["value"] == len(t["tokens"])
        assert len(t["flight"]) == steps
        assert all(tl["events"][-1]["kind"] == "terminal"
                   for tl in t["timelines"].values())
    spec = engine_runs["spec_ngram"][1]
    assert spec["snapshot"]["spec_accepted"] > 0
    assert spec["snapshot"]["token_ledger"]["spec_accepted"] > 0
    fault = engine_runs["host_tier_decode_fault"][1]
    assert fault["snapshot"]["step_failures"] == {"decode": 1}
    assert fault["snapshot"]["host_tier_hits"] > 0
    assert fault["snapshot"]["token_ledger"]["recompute_replay"] > 0
    assert set(fault["dumps"]) == {"degraded", "drain"}
    extra, _, _, _, retried = fault["dumps"]["degraded"]
    assert extra["phase"] == "decode" and "injected fault" in extra["error"]
    assert retried == ["0"]
    assert fault["counters"]["fault_injected_total"][0]["value"] == 1
    assert {"labels": {"site": "serving.step.decode"}, "value": 1} in \
        fault["counters"]["watchdog_degraded_total"]
    assert fault["gauges"]["serving_health_state"]
    assert "serving_host_tier_bytes" in fault["gauges"]


# ---------------------------------------------------------------------------
# (f) the goodput ledger's contract
# ---------------------------------------------------------------------------

def ledger_clean(eng, clock):
    for n in (3, 5, 4):
        eng.add_request(list(range(1, n + 1)), max_new_tokens=3)
    _drive(eng)


def ledger_preempt(eng, clock):
    rng = np.random.RandomState(7)
    for _ in range(3):
        eng.add_request(rng.randint(0, 128, (24,)).tolist(),
                        max_new_tokens=12)
    _drive(eng)


def ledger_expired(eng, clock):
    eng.add_request([3, 1, 4, 1, 5], max_new_tokens=50, deadline_s=5.0)
    eng.add_request([2, 7, 1], max_new_tokens=4)
    for _ in range(4):
        eng.step()
    clock.t += 6.0
    _drive(eng)


LEDGERS = {"clean": ledger_clean, "preempt_reprefill": ledger_preempt,
           "expired_partial": ledger_expired}


@pytest.mark.parametrize("name", list(LEDGERS))
def test_goodput_ledger_matches_jax(make, clock, name):
    got = []
    jeng, teng = make(prefix_cache=False)
    for p, eng in ((JAX, jeng), (PORT, teng)):
        LEDGERS[name](eng, clock)
        m = eng.metrics
        assert sum(m.ledger.values()) == m.tokens_computed > 0
        got.append((dict(m.ledger), m.tokens_computed, m.preemptions,
                    dict(m.terminal), round(m.goodput_ratio, 6),
                    _counter(p.tel.snapshot(), "serving_goodput_ratio")))
    assert got[1] == got[0]
    ledger = got[1][0]
    if name == "clean":
        assert set(ledger) == {"goodput"} and got[1][4] == 1.0
    elif name == "preempt_reprefill":
        assert got[1][2] > 0 and ledger["preempt_reprefill"] > 0
    else:
        assert ledger["expired_partial"] > 0 and got[1][4] < 1.0


# ---------------------------------------------------------------------------
# (g) the request handoff across the packages
# ---------------------------------------------------------------------------

HANDOFF_REQS = [
    (list(range(3, 16)), dict(max_new_tokens=6)),
    ([9, 4, 7, 1, 8], dict(max_new_tokens=6, temperature=0.9, top_k=16,
                           seed=23)),
]


@pytest.fixture(scope="module")
def unmoved(make, module_clock):
    _, teng = make()
    rids = [teng.add_request(p, **kw) for p, kw in HANDOFF_REQS]
    done = _drive(teng)
    return [done[r].output_ids for r in rids]


@pytest.mark.parametrize("where", ["mid_decode", "mid_prefill"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_handoff_across_packages(make, clock, unmoved, direction, where):
    """``export_request`` on one package's engine, ``import_request`` on
    the other's, ``release_handoff`` on the source: the moved requests'
    tokens (one greedy, one seeded stochastic: the sampler state moves)
    equal the unmoved run; the source books what it computed and ends
    clean; the destination's timeline opens with ``handoff_in``."""
    jeng, teng = make()
    src, dst = (jeng, teng) if direction == "jax_to_port" else (teng, jeng)
    dst_pkg = PORT if dst is teng else JAX
    rids = [src.add_request(p, **kw) for p, kw in HANDOFF_REQS]
    moved = {}

    def move(rid):
        state = src.export_request(rid)
        assert state["kv"]["nbytes"] > 0
        moved[rid] = dst.import_request(state)
        src.release_handoff(rid, dest=1)

    if where == "mid_prefill":
        # the 13-token prompt after its first 8-token chunk
        src.step()
        assert src.migrate_ready() == [rids[0]]
        assert src.requests[rids[0]].state == "prefill"
        move(rids[0])
    for rid in rids:
        # the rest mid-decode, with two tokens out
        while rid not in moved:
            if (rid in src.handoff_ready()
                    and len(src.requests[rid].output) >= 2):
                move(rid)
            else:
                src.step()
    assert not src.has_work() and not src.requests
    src.pool.check_invariants()
    assert src.pool.num_free + src.pool.num_cached == src.pool.num_usable
    m = src.metrics
    assert m.ledger == {"goodput": m.tokens_computed}
    assert src.health()["handoffs"] == {"out": 2, "in": 0}
    done = _drive(dst)
    assert [done[moved[r]].output_ids for r in rids] == unmoved
    assert all(done[moved[r]].outcome == "ok" for r in rids)
    assert dst.health()["handoffs"] == {"out": 0, "in": 2}
    dm = dst.metrics
    assert sum(dm.ledger.values()) == dm.tokens_computed
    tl = dst_pkg.tel.request_timeline(moved[rids[0]])
    assert tl["events"][0]["kind"] == "handoff_in"


def test_handoff_errors_and_draining_match_jax(make, clock):
    """Unknown and not-yet-ready requests raise the same errors; a
    draining engine refuses an import with the same cause; a release with
    ``kind="migrated"`` books the same ledger."""
    jeng, teng = make()
    out = []
    for p, eng in ((JAX, jeng), (PORT, teng)):
        errs = []
        for rid in (999, eng.add_request([1, 2, 3, 4, 5], max_new_tokens=4)):
            try:
                eng.export_request(rid)
            except (KeyError, ValueError) as e:
                errs.append((type(e).__name__, str(e)))
        try:
            eng.release_handoff(999)
        except KeyError as e:
            errs.append(str(e))
        while not eng.handoff_ready():
            eng.step()
        rid = eng.handoff_ready()[0]
        state = eng.export_request(rid)
        eng.release_handoff(rid, kind="migrated")
        dst = make()[0 if p is JAX else 1]
        dst.drain()
        with pytest.raises(p.Rejected) as ei:
            dst.import_request(state)
        out.append((errs, dict(eng.metrics.ledger), ei.value.cause,
                    sorted(state)))
    assert out[1] == out[0]
    assert out[1][1] == {"migrated": out[1][1]["migrated"]}
    assert out[1][2] == "draining"


# ---------------------------------------------------------------------------
# (h) routing signals and fleet publishing
# ---------------------------------------------------------------------------

def test_routing_signals_and_fleet_publish_match_jax(make, clock):
    """``routing_signals`` and the published health documents equal the
    JAX engine's on the same state; the publication lands every
    ``every_steps`` steps, once at arming and once at the drain; with
    ``every_steps=0`` nothing is published."""
    jeng, teng = make()
    out = []
    for p, eng in ((JAX, jeng), (PORT, teng)):
        store, off = FakeStore(), FakeStore()
        eng.enable_fleet_publish(off, 1, every_steps=0)
        eng.enable_fleet_publish(store, 2, every_steps=2)
        for prompt, kw in _shared_prompts()[:4]:
            eng.add_request(prompt, **kw)
        signals = [eng.routing_signals()]
        for _ in range(3):
            eng.step()
            signals.append(eng.routing_signals())
        h = eng.health()
        assert signals[-1] == (h["state"], h["estimated_queue_delay_s"],
                               h["waiting"], h["occupancy"],
                               h["resident_tokens"])
        mid = json.loads(store[p.tel.KEY_PREFIX + "rank2"])["serving"]
        eng.drain()
        doc = json.loads(store[p.tel.KEY_PREFIX + "rank2"])
        assert doc["serving"]["state"] == "stopped" and not off
        fleet = p.tel.collect_fleet(store, 3)
        out.append((signals, store.sets, mid, doc["serving"],
                    fleet["metrics"], fleet["serving"], fleet["absent"]))
    for part in out:
        for health in (part[2], part[3], *part[5].values()):
            health.pop("paged_kernel")
    assert out[1] == out[0]
