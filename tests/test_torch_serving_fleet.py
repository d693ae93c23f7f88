"""The serving fleet (router with self-healing replicas, autoscaler,
disaggregated prefill/decode, live migration) in the PyTorch port, against
the JAX package's ``serving/fleet``.

- The policy units of tests/test_serving_fleet.py, tests/test_disagg.py
  and tests/test_serving_autoscale.py run on both packages, with the
  reference's expectations and equal results: ``choose_replica``
  (affinity, DEGRADED/JOINING, draining, fairness over 1k requests,
  routing within a role), ``view_from_health``/``views_from_fleet_doc``,
  ``decide`` and ``LoadWindow``, ``parse_roles`` and the write-ahead
  ``HandoffLedger`` on a duck-typed store.
- Two-replica fleets over a one-layer tiny Llama, on one fake clock, run
  side by side in both packages: (a) fault-free with affinity routing,
  (b) a replica killed mid-run, (c) resurrection through an
  ``engine_factory``, (d) whole-fleet loss that parks and heals, (e) a
  prefill/decode split with speculation off and n-gram, (f) an autoscaled
  burst up and idle down with migration on, (g) the migration matrix
  through ``MigrationCoordinator.migrate_one`` and (h) a hung replica
  under a step budget kept on the wall clock. Per fleet rid the tokens
  and outcome are equal; per fleet the routing, rejections, deaths,
  hangs, respawns, scale events (without their times), ledger counts,
  ``health()`` and every fleet, handoff and migration telemetry series.
  Every surviving port pool passes ``check_invariants`` with nothing
  leaked.
- With the cycle collector off, dropping an engine (speculation off,
  n-gram, draft) frees its pool, as does a replica that the router
  respawned, retired or abandoned as hung, and a whole fleet; the launch
  counters count exactly under threads, and two threads building one
  library write two temporary files.

The JAX engines run their plain paged attention and share one jitted
step and one pool size, so each signature compiles once.
"""

import contextlib
import gc
import json
import logging
import threading
import time
import weakref
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as pt
import paddle_tpu.serving.fleet as jfleet
from paddle_tpu import telemetry as jtel
from paddle_tpu.serving import RequestRejected as JRequestRejected
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import engine as jengine_mod
from paddle_tpu.serving import robustness as jrob
from paddle_tpu.serving import scheduler as jsched_mod
from paddle_tpu.serving.fleet import router as jrouter_mod
from paddle_tpu_torch import ServingEngine
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import telemetry as ttel
from paddle_tpu_torch.distributed import watchdog as twatchdog
from paddle_tpu_torch.ops.hopper import _build
from paddle_tpu_torch.ops.hopper import paged_attention as hpa
from paddle_tpu_torch.ops.hopper import rms_norm as hrms
from paddle_tpu_torch.serving import RequestRejected
from paddle_tpu_torch.serving import engine as tengine_mod
from paddle_tpu_torch.serving import robustness as trob
from paddle_tpu_torch.serving import scheduler as tsched_mod
import paddle_tpu_torch.serving.fleet as tfleet
from paddle_tpu_torch.serving.fleet import router as trouter_mod
from test_torch_serving_prefix_spec import _pair
from test_torch_serving_tier_robustness import Clock, flags
from torch_threads import one_torch_thread  # noqa: F401

JAX = SimpleNamespace(name="jax", fleet=jfleet, tel=jtel,
                      Rejected=JRequestRejected)
PORT = SimpleNamespace(name="port", fleet=tfleet, tel=ttel,
                       Rejected=RequestRejected)
PKGS = (JAX, PORT)

GEOM = dict(num_hidden_layers=1, num_key_value_heads=2,
            max_position_embeddings=96)
KNOBS = dict(block_size=4, max_slots=2, prefill_chunk=4)
# every engine of this module, factories' included: 31 usable blocks of 4
# tokens hold two slots of the longest request with the prefix cache on
POOL_BLOCKS = 32
# (the autoscaler's policy reads no clock: the router times its cooldown)
CLOCK_MODULES = (jengine_mod, jsched_mod, jrob, jrouter_mod, tengine_mod,
                 tsched_mod, trob, trouter_mod)
# the fake clock moves this far before every fleet step
DT = 0.01
HEAL_FLAGS = dict(serving_fleet_respawn_backoff_s=0.02,
                  serving_fleet_respawn_backoff_max_s=0.2,
                  serving_fleet_join_steps=2)


@pytest.fixture(scope="module", autouse=True)
def _jax_plain_attention():
    """The JAX side runs its plain paged attention; module-scoped, so the
    module-scoped engines below see it."""
    before = pt.get_flags("serving_paged_kernel")["serving_paged_kernel"]
    pt.set_flags({"serving_paged_kernel": "reference"})
    yield
    pt.set_flags({"serving_paged_kernel": before})


@contextlib.contextmanager
def telemetry_on(**kw):
    """Telemetry on in both packages with any other flags (fault rules
    re-armed), clean state before and after."""
    with flags(telemetry=True, **kw):
        for p in PKGS:
            p.tel.reset_all()
        try:
            yield
        finally:
            for p in PKGS:
                p.tel.stop_exporter()
                p.tel.reset_all()


@pytest.fixture(scope="module")
def models():
    return _pair(13, **GEOM)


@pytest.fixture(scope="module")
def make(models):
    """``make(pkg, **knobs)`` -> an engine of that package on the module's
    model. The JAX engines reuse the first one's jitted steps (the traced
    step reads only the model and its depth) and every pool has
    POOL_BLOCKS blocks, so a signature compiles once for the module."""
    jm, tm = models
    shared = {}

    def build(p, **kw):
        kw = dict(KNOBS, pool_blocks=POOL_BLOCKS, **kw)
        if p is PORT:
            return ServingEngine.from_model(tm, device="cpu", **kw)
        eng = JServingEngine.from_model(jm, **kw)
        for name in ("_step_jit", "_step_full_jit"):
            fn = getattr(eng, name)
            if fn is not None:
                setattr(eng, name, shared.setdefault(name, fn))
        return eng
    return build


class FakeTime:
    """``time`` for the routers: a parked fleet's sleep moves the fake
    clock instead of the wall clock."""

    def __init__(self, clock):
        self.clock = clock

    def sleep(self, s):
        self.clock.t += float(s)


@pytest.fixture(scope="module")
def module_clock():
    c = Clock()
    with pytest.MonkeyPatch.context() as mp:
        for mod in CLOCK_MODULES:
            mp.setattr(mod, "now_s", c)
        for mod in (jrouter_mod, trouter_mod):
            mp.setattr(mod, "time", FakeTime(c))
        yield c


@pytest.fixture
def clock(module_clock):
    module_clock.t, module_clock.tick = 1000.0, 0.0
    return module_clock


def _step(fleet, clock):
    if clock is not None:
        clock.t += DT
    return fleet.step()


def _drive(fleet, clock, max_steps=500):
    done = {}
    for _ in range(max_steps):
        if not fleet.has_work():
            return done
        done.update(_step(fleet, clock))
    raise AssertionError(f"fleet still busy after {max_steps} steps: "
                         f"{fleet.health()}")


def _heal(fleet, clock, max_steps=200):
    want = len(fleet.replicas)
    for _ in range(max_steps):
        h = fleet.health()
        if h["live"] == want and not h["joining"]:
            return
        _step(fleet, clock)
    raise AssertionError(f"fleet never healed: {fleet.health()}")


# ---------------------------------------------------------------------------
# the policy units, on both packages
# ---------------------------------------------------------------------------

def _v(F, rid, state="serving", delay=0.0, waiting=0, resident=0,
       occ=0.0, role="both"):
    return F.ReplicaView(rid, state, delay, waiting, resident, occ, role)


def _choose(p, views, **kw):
    """A decision as a plain tuple, or ("rejected", cause)."""
    try:
        d = p.fleet.choose_replica(views, **kw)
    except p.Rejected as e:
        return ("rejected", e.cause)
    return (d.replica_id, d.policy)


def u_affinity_only_when_resident(p):
    F = p.fleet
    out = [_choose(p, [_v(F, 0), _v(F, 1, delay=5.0, resident=8)]),
           _choose(p, [_v(F, 0), _v(F, 1, delay=5.0)]),
           _choose(p, [_v(F, 0), _v(F, 1, delay=5.0, resident=8)],
                   min_affinity_tokens=16),
           _choose(p, [_v(F, 0, delay=3.0, resident=8),
                       _v(F, 1, delay=1.0, resident=8)])]
    assert out == [(1, "affinity"), (0, "least_delay"),
                   (0, "least_delay"), (1, "affinity")]
    return out


def u_degraded_and_joining_receive_nothing(p):
    F = p.fleet
    out = [_choose(p, [_v(F, 0, state=s, resident=100),
                       _v(F, 1, delay=9.0)])
           for s in ("degraded", "joining")]
    out += [_choose(p, [_v(F, 0, state=a), _v(F, 1, state=b)])
            for a, b in (("degraded", "degraded"), ("joining", "joining"),
                         ("joining", "dead"))]
    assert out == [(1, "least_delay")] * 2 + [("rejected", "degraded")] * 3
    return out


def u_all_draining_raises_draining(p):
    F = p.fleet
    out = [_choose(p, [_v(F, i, state=s) for i, s in enumerate(states)])
           for states in (("draining", "draining"), ("draining", "stopped"),
                          ("stopped", "dead"), ())]
    assert out == [("rejected", "draining")] * 4
    return out


def u_fairness_over_1k_requests(p):
    rng = np.random.RandomState(42)
    n_rep, tok_per_s = 4, 100.0
    delay, counts, mass = [0.0] * n_rep, [0] * n_rep, [0.0] * n_rep
    picks = []
    for _ in range(1000):
        tokens = int(rng.randint(8, 64))
        rid, policy = _choose(p, [_v(p.fleet, i, delay=delay[i])
                                  for i in range(n_rep)])
        assert policy == "least_delay"
        picks.append(rid)
        counts[rid] += 1
        mass[rid] += tokens
        delay[rid] += tokens / tok_per_s
    assert all(200 <= c <= 300 for c in counts), counts
    mean = sum(mass) / n_rep
    assert all(abs(m - mean) / mean < 0.05 for m in mass), mass
    return picks


def u_routes_within_role(p):
    F = p.fleet
    out = []
    views = [_v(F, 0, role="prefill", delay=0.5), _v(F, 1, role="decode")]
    out += [_choose(p, views, role=r) for r in ("prefill", "decode")]
    views = [_v(F, 0, delay=0.4), _v(F, 1, role="decode")]
    out.append(_choose(p, views, role="prefill"))
    # affinity competes only within the role
    views = [_v(F, 0, role="prefill", delay=0.3),
             _v(F, 1, role="prefill", delay=0.1, resident=6),
             _v(F, 2, role="decode", resident=50)]
    out.append(_choose(p, views, role="prefill", min_affinity_tokens=4))
    # serving capacity, none of it in-role: retryable
    out.append(_choose(p, [_v(F, 0, role="prefill")], role="decode"))
    assert out == [(0, "least_delay"), (1, "least_delay"),
                   (0, "least_delay"), (1, "affinity"),
                   ("rejected", "degraded")]
    # an all-"both" fleet routes alike with and without the filter
    rng = np.random.RandomState(3)
    for _ in range(20):
        views = [_v(F, i, delay=float(rng.rand()),
                    waiting=int(rng.randint(0, 4)),
                    resident=int(rng.randint(0, 12))) for i in range(4)]
        base = _choose(p, views, min_affinity_tokens=4)
        out.append(base)
        for role in ("prefill", "decode"):
            assert _choose(p, views, min_affinity_tokens=4,
                           role=role) == base
    return out


def u_view_from_health_and_fleet_doc(p):
    F = p.fleet
    h = {"state": "serving", "estimated_queue_delay_s": 0.25, "waiting": 3}
    v = F.view_from_health(2, h, resident_tokens=8)
    assert v == F.ReplicaView(2, "serving", 0.25, 3, 8)
    doc = {"serving": {"1": h, "0": {"state": "draining",
                                     "estimated_queue_delay_s": 0,
                                     "waiting": 0},
                       "2": "corrupt"}}
    views = F.views_from_fleet_doc(doc)
    assert [(w.replica_id, w.state) for w in views] == [(0, "draining"),
                                                       (1, "serving")]
    return [tuple(v), [tuple(w) for w in views],
            tuple(F.view_from_health(5, {"occupancy": 0.5,
                                         "role": "decode"}))]


def _sv(F, rid, occ=0.0, waiting=0, state="serving"):
    """A view with occupancy in the defaulted slot (the autoscaler
    tests' ``_sv``)."""
    return F.ReplicaView(rid, state, 0.0, waiting, 0, occ)


def _window(F, samples, steps=4):
    w = F.LoadWindow(steps=steps)
    for sheds, backlog, occ, waiting in samples:
        w.note(sheds=sheds, backlog_tokens=backlog, occupancy=occ,
               waiting=waiting)
    return w


def _decide(F, views, backlog, samples, steps=4, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 4)
    d = F.decide(views, backlog, _window(F, samples, steps), **kw)
    return (d.direction, d.replica_id, d.role, d.reason)


def u_decide_scale_up(p):
    F = p.fleet

    def sv(*a, **kw):
        return _sv(F, *a, **kw)
    out = [_decide(F, [sv(0, 0.1)], 0, [(1, 0, 0.1, 0.0)], steps=8),
           _decide(F, [sv(0)], 37, [], steps=8),
           _decide(F, [sv(0, 0.95)], 0, [(0, 0, 0.95, 0.0)] * 3,
                   up_occupancy=0.85),
           _decide(F, [sv(0, 0.95)], 0, [(0, 0, 0.95, 0.0)] * 4,
                   up_occupancy=0.85),
           _decide(F, [sv(0, 0.75, 4)], 0, [(0, 0, 0.75, 2.0)] * 4,
                   up_occupancy=0.85),
           _decide(F, [sv(0, 1.0), sv(1, state="joining")], 99,
                   [(3, 0, 1.0, 5.0)] * 4, max_replicas=3, pending=1)]
    assert [o[0] for o in out] == ["up", "up", "hold", "up", "up", "hold"]
    assert "sheds" in out[0][3] and "backlog" in out[1][3]
    assert "mean_occupancy" in out[3][3] and "mean_waiting" in out[4][3]
    return out


def u_decide_scale_down(p):
    F = p.fleet

    def sv(*a, **kw):
        return _sv(F, *a, **kw)
    rv = F.ReplicaView
    idle = [(0, 0, 0.0, 0.0)] * 4
    calm = [(0, 0, 0.05, 0.0)] * 4
    out = [
        _decide(F, [sv(0, 0.5, 1), sv(1), sv(2)], 0, calm,
                down_occupancy=0.30),
        # fewest resident tokens first, then the load order
        _decide(F, [rv(0, "serving", 0.0, 0, 40, 0.0),
                    rv(1, "serving", 0.0, 0, 8, 0.25),
                    rv(2, "serving", 0.0, 0, 64, 0.0)], 0, calm,
                down_occupancy=0.30),
        _decide(F, [rv(0, "serving", 0.0, 0, 8, 0.2),
                    rv(1, "serving", 0.0, 0, 8, 0.0),
                    rv(2, "serving", 0.0, 0, 8, 0.0)], 0, calm,
                down_occupancy=0.30),
        # healing, pending, the floor and a partial window block it
        _decide(F, [sv(0), sv(1), sv(2, state="joining")], 0, idle),
        _decide(F, [sv(0), sv(1)], 0, idle, pending=1),
        _decide(F, [sv(0)], 0, idle),
        _decide(F, [sv(0), sv(1)], 0, idle[:1]),
        # the flap guard
        _decide(F, [sv(0, 0.88), sv(1)], 0, [(0, 0, 0.44, 0.0)] * 4,
                up_occupancy=0.85, down_occupancy=0.45),
        _decide(F, [sv(0, 0.20), sv(1)], 0, [(0, 0, 0.10, 0.0)] * 4,
                up_occupancy=0.85, down_occupancy=0.45),
        # monolithic fleets carry no role
        _decide(F, [sv(0, 0.1), sv(1)], 0, calm, down_occupancy=0.30),
    ]
    assert [o[:2] for o in out] == [
        ("down", 2), ("down", 1), ("down", 2), ("hold", None),
        ("hold", None), ("hold", None), ("hold", None), ("hold", None),
        ("down", 1), ("down", 1)]
    assert out[-1][2] is None
    return out


def u_decide_roles(p):
    F = p.fleet
    def rv(rid, role, occ=0.0, waiting=0):
        return F.ReplicaView(rid, "serving", 0.0, waiting, 0, occ, role)

    shed = [(2, 0, 0.3, 0.0)]
    idle = [(0, 0, 0.0, 0.0)] * 4
    calm = [(0, 0, 0.25, 0.0)] * 4
    decode_pair = [rv(0, "prefill", 0.3), rv(1, "prefill", 0.3),
                   rv(2, "decode", 0.9), rv(3, "decode")]
    out = [
        _decide(F, [rv(0, "prefill", 0.9, 3), rv(1, "decode", 0.1)], 0,
                shed, steps=8),
        _decide(F, [rv(0, "prefill", 0.1), rv(1, "decode", 0.9, 3)], 0,
                shed, steps=8),
        _decide(F, [rv(0, "prefill", 0.5), rv(1, "prefill", 0.5),
                    rv(2, "decode", 0.5)], 0, [(1, 0, 0.5, 0.0)], steps=8,
                max_replicas=6),
        _decide(F, [rv(0, "prefill"), rv(1, "decode"), rv(2, "decode")],
                0, idle, down_occupancy=0.30),
        _decide(F, [rv(0, "prefill"), rv(1, "decode")], 0, idle,
                down_occupancy=0.30),
        _decide(F, [rv(0, "both"), rv(1, "decode")], 0, idle,
                down_occupancy=0.30),
        _decide(F, decode_pair, 0, calm, max_replicas=6,
                up_occupancy=0.85, down_occupancy=0.45),
        _decide(F, decode_pair[:2] + [rv(2, "decode", 0.2), rv(3, "decode")],
                0, calm, max_replicas=6, up_occupancy=0.85,
                down_occupancy=0.45),
    ]
    assert [o[:3] for o in out] == [
        ("up", None, "prefill"), ("up", None, "decode"),
        ("up", None, "decode"), ("down", 2, "decode"),
        ("hold", None, None), ("down", 1, "decode"), ("hold", None, None),
        ("down", 3, "decode")]
    return out


def u_load_window(p):
    w = _window(p.fleet, [(1, 10, 0.5, 1.0), (0, 4, 0.7, 2.0)], steps=2)
    assert w.full and len(w) == 2 and w.sheds == 1 and w.max_backlog == 10
    assert w.mean_occupancy == pytest.approx(0.6)
    assert w.mean_waiting == pytest.approx(1.5)
    out = [w.snapshot(), w.min_waiting]
    w.note(sheds=0, backlog_tokens=0, occupancy=0.0, waiting=0.0)
    out.append(w.snapshot())
    assert len(w) == 2
    w.clear()
    assert len(w) == 0 and not w.full
    with flags(serving_fleet_scale_window_steps=3):
        out.append(p.fleet.LoadWindow().snapshot())
    return out


def u_parse_roles(p):
    parse = p.fleet.parse_roles
    out = [parse(""), parse("  "), parse("1:1"), parse("2:1")]
    assert out[2:] == [["prefill", "decode"],
                       ["prefill", "prefill", "decode"]]
    for bad in ("0:1", "1:0", "x:1", "1", "1:2:3", ":", "-1:2"):
        with pytest.raises(ValueError) as ei:
            parse(bad)
        out.append(str(ei.value))
    with flags(serving_fleet_roles="1:2"):
        out.append(parse())
    return out


class LedgerStore:
    """The set/delete surface of a journaling store."""

    def __init__(self):
        self.data = {}

    def set(self, key, value):
        self.data[key] = value

    def get(self, key, default=None):
        return self.data.get(key, default)

    def delete(self, key):
        self.data.pop(key, None)


def u_handoff_ledger(p):
    st = LedgerStore()
    led = p.fleet.HandoffLedger(st, max_entries=2)
    led.begin(7, src=0, dest=1, local_rid=3)
    key = "/serving/handoff/7"
    entry = json.loads(st.get(key))        # journaled BEFORE the move
    assert entry == {"fleet_rid": 7, "src": 0, "dest": 1,
                     "local_rid": 3, "phase": "begun"}
    out = [sorted(st.data), led.full]
    led.begin(8, src=0, dest=1, local_rid=4)
    out.append(led.full)
    led.commit(7)
    out += [sorted(st.data), led.full]
    led.abort(8, cause="import failed")
    led.commit(99)
    led.abort(99)
    out += [sorted(st.data), led.counts()]
    assert out[2:] == [True, ["/serving/handoff/8"], False, [],
                       {"pending": 0, "begun": 2, "committed": 1,
                        "aborted": 1}]
    # fail_source aborts only the dead source's entries, by name
    led = p.fleet.HandoffLedger(prefix="/serving/migrate/")
    for frid, src in ((1, 0), (2, 1), (3, 0)):
        led.begin(frid, src=src, dest=2, local_rid=0)
    out += [led.fail_source(0), sorted(led.pending), led.counts()]
    assert out[-3:-1] == [[1, 3], [2]]
    # the bound falls back to the flag
    with flags(serving_handoff_ledger_max=1):
        led = p.fleet.HandoffLedger()
        led.begin(1, src=0, dest=1, local_rid=0)
        out.append(led.full)
        led.commit(1)
        out.append(led.full)
    assert out[-2:] == [True, False]
    return out


UNITS = {f.__name__[2:]: f for f in (
    u_affinity_only_when_resident, u_degraded_and_joining_receive_nothing,
    u_all_draining_raises_draining, u_fairness_over_1k_requests,
    u_routes_within_role, u_view_from_health_and_fleet_doc,
    u_decide_scale_up, u_decide_scale_down, u_decide_roles, u_load_window,
    u_parse_roles, u_handoff_ledger)}


@pytest.mark.parametrize("name", list(UNITS))
def test_fleet_policy_matches_jax(name):
    assert UNITS[name](PORT) == UNITS[name](JAX)


def test_fleet_exports_and_flags_match_jax():
    """The reference's names but the tensor-parallel ones, and its fleet
    flags with their defaults and help, but ``serving_fleet_replicas``:
    only the fleet worker reads it, and the worker waits for slice 4."""
    skip = {"TPShardingPlan", "make_tp_mesh", "shard_engine_tp"}
    assert sorted(tfleet.__all__) == sorted(set(jfleet.__all__) - skip)
    jflags = pt.flags._REGISTRY
    names = [n for n in jflags if (n.startswith("serving_fleet_")
             or n == "serving_handoff_ledger_max")
             and n != "serving_fleet_replicas"]
    assert len(names) == 16
    assert "serving_fleet_replicas" not in tflags._REGISTRY
    for n in names:
        j, t = jflags[n], tflags._REGISTRY[n]
        assert (t.default, t.type, t.help) == (j.default, j.type, j.help), n


# ---------------------------------------------------------------------------
# fleets against the JAX fleet
# ---------------------------------------------------------------------------

def _fleet_workload():
    """tests/test_serving_fleet.py's workload, with its seeded stochastic
    request."""
    rng = np.random.RandomState(17)
    prompts = [rng.randint(0, 128, (n,)).tolist() for n in (5, 7, 6, 9)]
    kwargs = [dict(max_new_tokens=6), dict(max_new_tokens=6),
              dict(max_new_tokens=5, temperature=0.9, top_k=16, seed=23),
              dict(max_new_tokens=6)]
    return list(zip(prompts, kwargs))


def _submit(fleet, reqs):
    return [fleet.submit(pr, **kw) for pr, kw in reqs]


FAMILIES = ("serving_fleet_", "serving_handoff_", "serving_migrate_",
            "serving_terminal_total")
# health() fields read off the clock
CLOCK_FIELDS = ("respawn_pending",)


def _series(p):
    out = {}
    for name, fam in p.tel.snapshot_doc()["metrics"].items():
        if name.startswith(FAMILIES):
            out[name] = sorted((sorted(s.get("labels", {}).items()),
                                s["value"]) for s in fam["samples"])
    return out


def _observe(p, fleet, frids, done):
    """Everything compared per fleet, and per fleet rid."""
    h = fleet.health()
    reps = {rid: (r["state"], r["role"], r.get("retiring", False),
                  r.get("join_clean_steps"), r.get("death_reason"))
            for rid, r in h.pop("replicas").items()}
    for k in CLOCK_FIELDS:
        h.pop(k)
    death = p.tel.flight().dump_for("replica_death")
    dumps = dict(count=p.tel.flight().dumps,
                 replica_death=None if death is None else death["extra"])
    digests = [(d.get("kind"), d.get("replica"), d.get("fleet_rid"),
                d.get("from_replica"), d.get("to_replica"))
               for d in p.tel.flight().snapshot() if d.get("src") == "fleet"]
    return dict(
        tokens={f: list(done[f].output_ids) for f in frids},
        outcomes={f: done[f].outcome for f in frids},
        placed={f: fleet.requests[f].replica_id for f in frids},
        routed=dict(fleet.routed), rejected=dict(fleet.rejected),
        deaths=list(fleet.deaths), hangs=fleet.hangs,
        respawns=fleet.respawns,
        scale=[{k: v for k, v in e.items() if k != "t_s"}
               for e in fleet.scale_events],
        handoffs=(None if fleet._disagg is None
                  else fleet._disagg.ledger.counts()),
        migrations=fleet._migrate.ledger.counts(),
        health=h, replicas=reps, series=_series(p), dumps=dumps,
        digests=digests)


def _check_pools(fleet):
    """Every surviving port pool is consistent and leaks nothing."""
    for rep in fleet.replicas.values():
        if rep.dead:
            continue
        pool = rep.engine.pool
        pool.check_invariants()
        assert pool.num_free + pool.num_cached == pool.num_usable


def _both(run, fake, **kw):
    """``run(p, ...)`` -> (fleet, frids, done) in both packages from one
    reading of the fake clock; returns the port's observation (equal to
    the JAX one) and the port's run."""
    obs, port = {}, None
    for p in PKGS:
        fake.t = 1000.0
        fleet, frids, done = run(p, **kw)
        obs[p.name] = _observe(p, fleet, frids, done)
        if p is PORT:
            port = (fleet, frids, done)
            _check_pools(fleet)
    assert obs["port"] == obs["jax"]
    return obs["port"], port


def run_fault_free(p, make, clock):
    """(a): two waves of the workload; the second finds its prompts
    resident and routes by affinity."""
    fleet = p.fleet.FleetRouter([p.fleet.EngineReplica(i, make(p))
                                 for i in range(2)])
    frids = _submit(fleet, _fleet_workload())
    done = _drive(fleet, clock)
    frids += _submit(fleet, _fleet_workload())
    done.update(_drive(fleet, clock))
    done.update(fleet.drain())
    return fleet, frids, done


def run_replica_death(p, make, clock):
    """(b): replica 1 dies at its third step; no factory."""
    fleet = p.fleet.FleetRouter([p.fleet.EngineReplica(i, make(p))
                                 for i in range(2)])
    frids = _submit(fleet, _fleet_workload())
    done = _drive(fleet, clock)
    done.update(fleet.drain())
    return fleet, frids, done


def run_resurrection(p, make, clock):
    """(c): replica 1 dies and respawns through JOINING; after the heal
    two submits land one on each replica."""
    def factory():
        return make(p)

    fleet = p.fleet.FleetRouter([p.fleet.EngineReplica(i, factory())
                                 for i in range(2)], engine_factory=factory)
    rng = np.random.RandomState(17)
    frids = [fleet.submit(rng.randint(0, 128, (n,)).tolist(),
                          max_new_tokens=4) for n in (5, 7, 6, 9)]
    done = _drive(fleet, clock)
    _heal(fleet, clock)
    frids += _submit(fleet, [([1, 2, 3, 4, 5], dict(max_new_tokens=3)),
                             ([9, 8, 7, 6, 5], dict(max_new_tokens=3))])
    assert fleet.requests[frids[-1]].replica_id == 1
    done.update(_drive(fleet, clock))
    done.update(fleet.drain())
    return fleet, frids, done


def run_whole_fleet_loss(p, make, clock):
    """(d): both replicas die; the fleet parks, a deadline request
    expires in the backlog, the rest finish after the respawns."""
    def factory():
        return make(p)

    fleet = p.fleet.FleetRouter([p.fleet.EngineReplica(i, factory())
                                 for i in range(2)], engine_factory=factory)
    rng = np.random.RandomState(17)
    frids = [fleet.submit(rng.randint(0, 128, (n,)).tolist(),
                          max_new_tokens=4) for n in (5, 7, 6)]
    frids.append(fleet.submit([3, 4, 5, 6], max_new_tokens=4,
                              deadline_s=0.05))
    done = _drive(fleet, clock)
    assert not fleet.backlog and not fleet.has_work()
    done.update(fleet.drain())
    return fleet, frids, done


def _split_requests():
    """tests/test_disagg.py's mix: three prefix sharers, seeded
    stochastic riders."""
    rng = np.random.RandomState(7)
    prefix = list(range(1, 13))
    reqs = []
    for i in range(6):
        if i < 3:
            pr = prefix + rng.randint(0, 64, (3,)).tolist()
        else:
            pr = rng.randint(0, 64, (int(rng.randint(4, 10)),)).tolist()
        kw = dict(max_new_tokens=5)
        if i % 2 == 1:
            kw.update(temperature=0.9, top_k=16, seed=23 + i)
        reqs.append((pr, kw))
    return reqs


def run_split(p, make, clock, roles=("prefill", "decode"), spec=None):
    """(e): a role-split fleet; every request hands off once."""
    def factory():
        return make(p, spec=spec)

    fleet = p.fleet.FleetRouter(
        [p.fleet.EngineReplica(i, factory(), role=r)
         for i, r in enumerate(roles)], engine_factory=factory)
    frids = _submit(fleet, _split_requests())
    done = _drive(fleet, clock)
    done.update(fleet.drain())
    return fleet, frids, done


AUTOSCALE_FLAGS = dict(HEAL_FLAGS, serving_fleet_scale_cooldown_s=0.02,
                       serving_fleet_scale_window_steps=2,
                       serving_fleet_min_replicas=1,
                       serving_fleet_max_replicas=2,
                       serving_fleet_migrate=True)


def run_autoscale(p, make, clock):
    """(f): a burst on one replica scales up through JOINING, the idle
    tail retires back to one."""
    def factory():
        return make(p)

    fleet = p.fleet.FleetRouter([p.fleet.EngineReplica(0, factory())],
                                engine_factory=factory)
    fleet.enable_autoscale()
    rng = np.random.RandomState(7)
    frids = [fleet.submit(rng.randint(0, 128, (6,)).tolist(),
                          max_new_tokens=5) for _ in range(6)]
    done = {}
    for _ in range(400):
        done.update(_step(fleet, clock))
        h = fleet.health()
        dirs = {e["direction"] for e in fleet.scale_events}
        if (len(done) == len(frids) and h["live"] == 1
                and not h["retiring"] and not h["joining"]
                and dirs == {"up", "down"}):
            break
    done.update(fleet.drain())
    return fleet, frids, done


def run_migration(p, make, clock, mode, depth):
    """(g): one request moved by ``migrate_one`` at a depth: mid-prefill
    (prefill chunks of 4), after 1 or 3 tokens; ``depth=None`` leaves it
    where it is."""
    kw = dict(max_new_tokens=6)
    if mode == "stochastic":
        kw.update(temperature=0.9, top_k=16, seed=29)
    prefix = list(range(1, 9))
    prompt = prefix + np.random.RandomState(13).randint(0, 64, (8,)).tolist()

    def build():
        eng = make(p)
        if mode == "prefix":
            # the prompt enters as a prefix hit on every engine
            eng.add_request(prefix + [70, 71], max_new_tokens=2)
            while eng.has_work():
                eng.step()
        return eng

    fleet = p.fleet.FleetRouter([p.fleet.EngineReplica(i, build())
                                 for i in range(2)])
    frid = fleet.submit(prompt, **kw)
    rr = fleet.requests[frid]
    src = fleet.replicas[rr.replica_id]
    done = {}
    if depth is not None:
        while True:
            seq = src.engine.requests[rr.local_rid]
            ready = rr.local_rid in src.engine.migrate_ready()
            if ready and (depth == "mid-prefill"
                          or len(seq.output) >= depth):
                break
            done.update(_step(fleet, clock))
        if depth == "mid-prefill":
            assert not seq.output and 0 < seq.ctx < len(prompt)
        assert fleet._migrate.migrate_one(src, rr.local_rid,
                                          reason="test")
        assert rr.replica_id != src.replica_id
    done.update(_drive(fleet, clock))
    done.update(fleet.drain())
    return fleet, [frid], done


@pytest.fixture(scope="module")
def fault_free(make, module_clock):
    module_clock.tick = 0.0
    with telemetry_on():
        return _both(run_fault_free, module_clock, make=make,
                     clock=module_clock)


def test_fleet_fault_free_matches_jax(fault_free):
    obs, (fleet, frids, done) = fault_free
    assert all(o == "ok" for o in obs["outcomes"].values())
    assert obs["routed"]["affinity"] > 0 and obs["routed"]["reroute"] == 0
    assert obs["deaths"] == [] and obs["health"]["state"] == "stopped"
    # the second wave repeats the first, token for token
    assert [done[f].output_ids for f in frids[:4]] == \
        [done[f].output_ids for f in frids[4:]]


def test_fleet_replica_death_matches_jax(fault_free, make, clock):
    with telemetry_on(fault_spec="serving.fleet.replica:key=1:after=2"):
        obs, _ = _both(run_replica_death, clock, make=make, clock=clock)
    assert obs["deaths"] == [1] and obs["routed"]["reroute"] >= 1
    assert all(o == "ok" for o in obs["outcomes"].values())
    assert list(obs["tokens"].values()) == \
        list(fault_free[0]["tokens"].values())[:4]
    extra = obs["dumps"]["replica_death"]
    assert extra["replica"] == 1 and extra["in_flight_rids"]


def test_fleet_resurrection_matches_jax(make, clock):
    with telemetry_on(fault_spec="serving.fleet.replica:key=1:after=1:"
                      "times=1", **HEAL_FLAGS):
        obs, _ = _both(run_resurrection, clock, make=make, clock=clock)
    assert obs["deaths"] == [1] and obs["respawns"] == 1
    assert all(o == "ok" for o in obs["outcomes"].values())
    kinds = [(k, r) for k, r, *_ in obs["digests"]]
    assert ("respawn", 1) in kinds and ("rejoin", 1) in kinds
    assert obs["health"]["dead"] == [] and obs["health"]["deaths_total"] == 1


def test_fleet_whole_loss_parks_and_heals_like_jax(make, clock):
    with telemetry_on(fault_spec="serving.fleet.replica:times=2",
                      serving_fleet_respawn_backoff_s=0.1,
                      serving_fleet_respawn_backoff_max_s=0.3,
                      serving_fleet_join_steps=2):
        obs, _ = _both(run_whole_fleet_loss, clock, make=make, clock=clock)
    assert sorted(obs["deaths"]) == [0, 1] and obs["respawns"] >= 1
    assert list(obs["outcomes"].values()) == ["ok"] * 3 + ["expired"]
    assert obs["series"]["serving_terminal_total"]


@pytest.mark.parametrize("spec", [None, "ngram"])
def test_fleet_role_split_matches_jax(make, clock, spec):
    with telemetry_on(serving_prefix_cache=True):
        obs, _ = _both(run_split, clock, make=make, clock=clock, spec=spec)
        clock.t = 1000.0
        mono = run_split(PORT, make, clock, roles=("both", "both"),
                         spec=spec)
    assert obs["handoffs"] == {"pending": 0, "begun": 6, "committed": 6,
                               "aborted": 0}
    assert obs["health"]["roles"] == {"prefill": 1, "decode": 1}
    assert all(o == "ok" for o in obs["outcomes"].values())
    _, frids, done = mono
    assert list(obs["tokens"].values()) == [done[f].output_ids
                                            for f in frids]


def test_fleet_autoscale_matches_jax(make, clock):
    with telemetry_on(**AUTOSCALE_FLAGS):
        obs, _ = _both(run_autoscale, clock, make=make, clock=clock)
    dirs = [e["direction"] for e in obs["scale"]]
    assert "up" in dirs and "down" in dirs
    assert all(o == "ok" for o in obs["outcomes"].values())
    for e in obs["scale"]:
        assert {"reason", "window", "mean_occupancy"} <= set(e)


@pytest.mark.parametrize("mode", ["greedy", "stochastic", "prefix"])
def test_fleet_migration_matrix_matches_jax(make, clock, mode):
    with telemetry_on(serving_prefix_cache=True):
        clock.t = 1000.0
        _, frids, done = run_migration(PORT, make, clock, mode, None)
        want = done[frids[0]].output_ids
        assert len(want) == 6
        for depth in ("mid-prefill", 1, 3):
            for p in PKGS:
                p.tel.reset_all()
            obs, _ = _both(run_migration, clock, make=make, clock=clock,
                           mode=mode, depth=depth)
            assert list(obs["tokens"].values()) == [want], depth
            assert obs["migrations"]["committed"] == 1
            assert obs["series"]["serving_fleet_migrations_total"][0][1] \
                == 1
            assert obs["series"]["serving_migrate_bytes_total"][0][1] > 0


def run_hung(p, make, clock):
    """(h): the replicas are warmed without a budget, then replica 1's
    step sleeps past a 0.3 s budget once. The budget is kept on the wall
    clock (the worker's result queue), whatever ``now_s`` reads."""
    fleet = p.fleet.FleetRouter([p.fleet.EngineReplica(i, make(p))
                                 for i in range(2)])
    rng = np.random.RandomState(17)
    frids = [fleet.submit(rng.randint(0, 128, (n,)).tolist(),
                          max_new_tokens=2) for n in (5, 9, 16, 3)]
    done = _drive(fleet, clock)
    with flags(fault_spec="serving.fleet.replica_hang:key=1:sleep=1.0:"
               "times=1", serving_fleet_step_timeout_s=0.3):
        frids += [fleet.submit(rng.randint(0, 128, (n,)).tolist(),
                               max_new_tokens=4) for n in (5, 7, 6, 9)]
        t0 = time.monotonic()
        done.update(_drive(fleet, clock))
        assert time.monotonic() - t0 < 1.0     # the hang was abandoned
        assert "fleet budget" in fleet.replicas[1].death_reason
        done.update(fleet.drain())
    return fleet, frids, done


def test_fleet_hung_replica_matches_jax(make, clock):
    with telemetry_on():
        obs, _ = _both(run_hung, clock, make=make, clock=clock)
    assert obs["deaths"] == [1] and obs["hangs"] == 1
    assert all(o == "ok" for o in obs["outcomes"].values())
    extra = obs["dumps"]["replica_death"]
    assert extra["cause"] == "hang" and extra["replica"] == 1
    assert obs["series"]["serving_fleet_hangs_total"][0][1] == 1


# ---------------------------------------------------------------------------
# repairs: a dropped engine frees its pool; launch counts under threads
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def no_cycle_collector():
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


@pytest.mark.parametrize("spec", ["off", "ngram", "draft"])
def test_dropped_engine_frees_pool_without_cycle_collector(models, spec):
    """Nothing of the engine holds the engine: ``del`` frees the pool
    (and with it, on the card, the pool's device memory) at once."""
    tm = models[1]
    with no_cycle_collector():
        eng = ServingEngine.from_model(
            tm, device="cpu", spec=spec, pool_blocks=POOL_BLOCKS,
            draft_model=tm if spec == "draft" else None, **KNOBS)
        eng.add_request([1, 2, 3, 4, 5, 1, 2, 3], max_new_tokens=6)
        eng.run()
        assert eng.readiness_probe()
        pool = weakref.ref(eng.pool)
        del eng
        assert pool() is None


class _KeepRecords(logging.Handler):
    """A handler that keeps every record, as a test's log capture does."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.mark.parametrize("fault,retries,outcome", [
    ("serving.prefill:times=1", 2, "ok"),
    ("serving.prefill", 0, "failed")], ids=["retried", "quarantined"])
def test_engine_after_step_failure_frees_pool_without_cycle_collector(
        models, monkeypatch, fault, retries, outcome):
    """A step that failed is reported to the log; a handler that keeps
    the record must not keep the exception, whose traceback's frames hold
    the engine and its pool."""
    monkeypatch.setattr(twatchdog, "_degraded_seen", set())
    keep = _KeepRecords()
    twatchdog.logger.addHandler(keep)
    try:
        with flags(fault_spec=fault, serving_step_retries=retries), \
                no_cycle_collector():
            eng = ServingEngine.from_model(models[1], device="cpu",
                                           pool_blocks=POOL_BLOCKS, **KNOBS)
            rid = eng.add_request([1, 2, 3, 4, 5, 1, 2, 3],
                                  max_new_tokens=6)
            assert eng.run()[rid].outcome == outcome
            pool = weakref.ref(eng.pool)
            del eng
            assert pool() is None
    finally:
        twatchdog.logger.removeHandler(keep)
    assert [r.getMessage().startswith("degraded path at serving.step")
            for r in keep.records] == [True]


@pytest.mark.parametrize("how", ["respawned", "retired", "hung"])
def test_dropped_replica_frees_pool_without_cycle_collector(make, clock,
                                                            how):
    """A replica the router lets go of (dead and respawned, retired by a
    scale-down, or dead by hang with its worker thread returned) frees
    its pool without the cycle collector."""
    def factory():
        return make(PORT)

    spec = {"respawned": "serving.fleet.replica:key=1:after=1:times=1",
            "retired": "",
            "hung": "serving.fleet.replica_hang:key=1:sleep=0.3:times=1"}
    budget = 0.1 if how == "hung" else 0.0
    with flags(fault_spec=spec[how], serving_fleet_step_timeout_s=budget,
               serving_drain_timeout_s=0.0, **HEAL_FLAGS), \
            no_cycle_collector():
        fleet = tfleet.FleetRouter([tfleet.EngineReplica(i, factory())
                                    for i in range(2)],
                                   engine_factory=factory)
        pool = weakref.ref(fleet.replicas[1].engine.pool)
        frids = _submit(fleet, _fleet_workload())
        done = _step(fleet, clock)
        worker = fleet.replicas[1]._worker
        if how == "retired":
            assert fleet.scale_down(1)
        done.update(_drive(fleet, clock))
        if how == "hung":
            # the abandoned step returns on its worker thread, which then
            # ends; the engine goes with it
            worker.join(5.0)
            assert not worker.is_alive()
        del worker
        if how != "retired":
            _heal(fleet, clock)
        assert all(done[f].outcome == "ok" for f in frids)
        assert (1 in fleet.replicas) == (how != "retired")
        assert fleet.replicas.get(1) is None or \
            fleet.replicas[1].engine.pool is not pool()
        fleet.drain()
        assert pool() is None


@pytest.mark.parametrize("roles", [("both", "both"), ("prefill", "decode")])
def test_dropped_fleet_frees_pools_without_cycle_collector(make, clock,
                                                           roles):
    """A fleet that served and was dropped frees every replica's pool
    without the cycle collector: its coordinators hold it weakly."""
    with no_cycle_collector():
        fleet = tfleet.FleetRouter(
            [tfleet.EngineReplica(i, make(PORT), role=r)
             for i, r in enumerate(roles)])
        pools = [weakref.ref(r.engine.pool)
                 for r in fleet.replicas.values()]
        frids = _submit(fleet, _fleet_workload())
        done = _drive(fleet, clock)
        assert all(done[f].outcome == "ok" for f in frids)
        del fleet
        assert [p() for p in pools] == [None, None]


def test_launch_counts_exact_under_threads():
    """Replicas step on threads of their own under a step budget: each
    wrapper's count must not lose a launch. Several threads run the plain
    versions (there is no card here) and count through the wrappers'
    counting path."""
    n_threads, n_calls = 4, 200
    x = torch.randn(8, 64)
    w = torch.randn(64)
    before = (hpa.paged_attend_cuda.launches, hrms.rms_norm_cuda.launches)
    switch = __import__("sys").getswitchinterval()
    __import__("sys").setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_calls):
                hrms.rms_norm_reference(x, w, 1e-6)
                _build.count_launch(hrms.rms_norm_cuda)
                _build.count_launch(hpa.paged_attend_cuda)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        __import__("sys").setswitchinterval(switch)
    got = (hpa.paged_attend_cuda.launches - before[0],
           hrms.rms_norm_cuda.launches - before[1])
    assert got == (n_threads * n_calls,) * 2
    hpa.paged_attend_cuda.launches, hrms.rms_norm_cuda.launches = before


def test_build_names_are_private_to_each_thread(monkeypatch, tmp_path):
    """Two threads building one library at once write two temporary
    files, then rename; no nvcc is needed to see the names."""
    names = []
    lock = threading.Lock()
    barrier = threading.Barrier(2)

    class Done:
        returncode, stdout, stderr = 0, "", ""

    def fake_run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        with lock:
            names.append(out)
        barrier.wait(5.0)
        open(out, "wb").close()
        return Done()

    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "library_path",
                        lambda name, sources: tmp_path / f"lib{name}.so")
    results = []
    threads = [threading.Thread(target=lambda: results.append(
        _build.build_library("k", ["rms_norm.cu"]))) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(set(names)) == 2 and len(results) == 2
    assert (tmp_path / "libk.so").is_file()
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["", "serving.prefill:times=1"],
                         ids=["clean", "step_failure"])
def test_dropped_engine_frees_card_memory_without_cycle_collector(fault):
    """On the card: a speculating engine's pool leaves device memory when
    the engine is dropped, with the cycle collector off, also after a
    step that failed and was retried (head_dim 64, a width K5 takes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paddle_tpu_torch import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig.tiny(
        num_hidden_layers=1, num_attention_heads=1, num_key_value_heads=1,
        max_position_embeddings=96), device="cuda")
    with flags(fault_spec=fault), no_cycle_collector():
        eng = ServingEngine.from_model(model, spec="ngram",
                                       pool_blocks=4096, **KNOBS)
        rid = eng.add_request([1, 2, 3, 4, 5, 1, 2, 3], max_new_tokens=6)
        assert eng.run()[rid].outcome == "ok"
        assert sum(eng.metrics.step_failures.values()) == (1 if fault else 0)
        pool_bytes = eng.pool._kv.numel() * eng.pool._kv.element_size()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        del eng
        torch.cuda.synchronize()
        assert held - torch.cuda.memory_allocated() >= pool_bytes
