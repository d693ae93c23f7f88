"""Serving's host-RAM KV tier (spill and restore, export and import of a
sequence's blocks) and the engine's robustness contract (deadlines,
cancel, shedding, step-failure quarantine, drain, health, fault points)
in the PyTorch port, against the JAX package.

- The fault registry: the same spec strings parse to the same rules and
  fire at the same calls in both packages.
- The port's ``KVBlockPool`` with the host tier on and the JAX one take
  the same seeded runs of acquire, write (ensure, copy-on-write,
  register), trim, free and probe, with a starved cached set so freed
  chains spill, a host cap small enough to age entries out, and an armed
  ``serving.host_tier.restore`` rule so some restores fault. After each
  operation the tables, refcounts, index, cached LRU order, free list,
  host keys in LRU order, counters, ``stats()``, every pool buffer and
  every host entry's bytes are equal, and both pools pass
  ``check_invariants``.
- ``export_seq``/``import_seq``: the same manifest keys as the JAX pool,
  byte-equal blocks across the two packages both ways, and the same
  errors on geometry mismatches.
- bench.py's ``zipf-hosttier`` mix at its CPU sizes (without its warm-up
  requests), run ``device``, ``host`` and ``cold`` on both engines:
  tokens, tokens computed, host hits, spills and admission prices equal.
- The robustness cases of tests/test_serving_robustness.py on both
  engines, on one fake clock: outcomes, retries, step failures, sheds,
  lifecycle states and tokens equal.
- The speculation fault contract on prompts whose drafts are accepted
  (the JAX package's own test of it is red: its prompts accept none).

Everything runs on the CPU with one-layer models; the JAX engines run
their plain paged attention and share one compiled step (the model and
the shapes are the same), so each signature compiles once.
"""

import contextlib

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as pt
from paddle_tpu.distributed import fault as jfault
from paddle_tpu.serving import KVBlockPool as JKVBlockPool
from paddle_tpu.serving import RequestRejected as JRequestRejected
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving import engine as jengine_mod
from paddle_tpu.serving import robustness as jrob
from paddle_tpu.serving import scheduler as jsched_mod
from paddle_tpu_torch import ServingEngine
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.distributed import fault as tfault
from paddle_tpu_torch.serving import KVBlockPool, RequestRejected
from paddle_tpu_torch.serving import engine as tengine_mod
from paddle_tpu_torch.serving import robustness as trob
from paddle_tpu_torch.serving import scheduler as tsched_mod
from test_torch_serving_prefix_spec import (POOL_COUNTERS, _both,
                                            _cycling_prompts, _pair,
                                            _pool_state, _zipf_prompts)
from torch_threads import one_torch_thread  # noqa: F401

GEOM = dict(num_hidden_layers=1, num_key_value_heads=2,
            max_position_embeddings=96)


@pytest.fixture(scope="module", autouse=True)
def _jax_plain_attention():
    """The JAX side runs its plain paged attention; module-scoped, so the
    module-scoped engines below see it."""
    before = pt.get_flags("serving_paged_kernel")["serving_paged_kernel"]
    pt.set_flags({"serving_paged_kernel": "reference"})
    yield
    pt.set_flags({"serving_paged_kernel": before})


@contextlib.contextmanager
def flags(**kw):
    """Set the same FLAGS_* in both packages for the block; fault rules
    are re-armed by the flag and their counters zeroed."""
    names = ["FLAGS_" + k for k in kw]
    old_j, old_t = pt.get_flags(names), tflags.get_flags(names)
    new = {"FLAGS_" + k: v for k, v in kw.items()}
    pt.set_flags(new)
    tflags.set_flags(new)
    jfault.reset()
    tfault.reset()
    try:
        yield
    finally:
        pt.set_flags(old_j)
        tflags.set_flags(old_t)
        jfault.reset()
        tfault.reset()


@pytest.fixture(scope="module")
def models():
    return _pair(11, **GEOM)


@pytest.fixture(scope="module")
def make(models):
    """``make(**knobs)`` -> (JAX engine, port engine) on the same model.
    Every JAX engine reuses the first one's jitted steps (the traced step
    reads only the model and its depth) and every engine's pool has
    POOL_BLOCKS blocks (the pool's shape is part of each signature), so a
    signature compiles once for the whole module."""
    jm, tm = models
    shared = {}

    def build(**kw):
        kw.setdefault("pool_blocks", POOL_BLOCKS)
        jeng = JServingEngine.from_model(jm, **kw)
        for name in ("_step_jit", "_step_full_jit"):
            fn = getattr(jeng, name)
            if fn is not None:
                setattr(jeng, name, shared.setdefault(name, fn))
        return jeng, ServingEngine.from_model(tm, device="cpu", **kw)
    return build


class Clock:
    """One fake ``now_s`` for both packages: ``t`` moves by ``tick`` on
    every read."""

    def __init__(self, t=1000.0, tick=0.0):
        self.t, self.tick = t, tick

    def __call__(self):
        t = self.t
        self.t += self.tick
        return t


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    for mod in (jengine_mod, jsched_mod, jrob, tengine_mod, tsched_mod,
                trob):
        monkeypatch.setattr(mod, "now_s", c)
    return c


# ---------------------------------------------------------------------------
# (a) the fault registry
# ---------------------------------------------------------------------------

FAULT_SPECS = [
    "serving.decode:times=2",
    "serving.sample:key=1:after=1:times=1",
    "serving.prefill:step=3,serving.decode:after=2",
    "serving.pool_alloc:rank=0:round=0:times=1",
    "serving.pool_alloc:rank=1",
    "serving.decode:sleep=0:times=1,serving.decode:nan,"
    "serving.decode:after=4:times=1",
]
FAULT_CALLS = [("serving.decode", dict(step=s)) for s in range(6)] + [
    ("serving.sample", dict(step=s, key=str(k)))
    for s in range(3) for k in (0, 1, 11)] + [
    ("serving.prefill", dict(step=s, key="0")) for s in range(5)] + [
    ("serving.pool_alloc", dict(key=str(k))) for k in range(3)] + [
    ("serving.pool_alloc", dict(key="4", rank=1))]


def _fire_all(mod):
    """Which of FAULT_CALLS raise under the armed rules, and the rules'
    counters after them."""
    fired = []
    for i, (site, ctx) in enumerate(FAULT_CALLS):
        try:
            mod.fault_point(site, **ctx)
        except mod.FaultInjected:
            fired.append(i)
    return fired, [(r.site, r.action, r.rank, r.round, r.step, r.key,
                    r.after, r.times, r.sleep_s, r.calls, r.fired)
                   for r in mod._RULES]


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_registry_matches_jax(spec):
    """Every filter and action of the grammar: the same rules, fired at
    the same calls, with the same counts (``nan`` is a no-op at plain
    sites); ``reset`` zeroes the counts and keeps the rules."""
    with flags(fault_spec=spec):
        assert tfault.enabled() and jfault.enabled()
        got = _fire_all(tfault)
        assert got == _fire_all(jfault)
        assert got[0], "the spec never fired"
        tfault.reset()
        assert all(r.calls == r.fired == 0 for r in tfault._RULES)
    assert not tfault.enabled()


@pytest.mark.parametrize("action", ["truncate", "corrupt"])
def test_fault_file_actions_match_jax(tmp_path, action):
    data = bytes(range(256)) * 4
    out = []
    for mod, name in ((jfault, "j.bin"), (tfault, "t.bin")):
        path = tmp_path / name
        path.write_bytes(data)
        with flags(fault_spec=f"ckpt.write_shard:{action}:times=1"):
            mod.fault_point("ckpt.write_shard", path=str(path))
            mod.fault_point("ckpt.write_shard", path=str(path))
        out.append(path.read_bytes())
    assert out[0] == out[1] != data


@pytest.mark.parametrize("bad", ["serving.decode:when=3", "serving.decode:x",
                                 ":"])
def test_fault_spec_errors_match_jax(bad):
    errs = []
    for mod in (jfault, tfault):
        with pytest.raises(ValueError) as ei:
            mod._parse(bad)
        errs.append(str(ei.value))
    assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# (b) the pool with the host tier, operation by operation
# ---------------------------------------------------------------------------

TIER_COUNTERS = POOL_COUNTERS + ("host_hits", "host_hit_tokens",
                                 "host_restore_failures")
POOL_GEOM = dict(num_layers=2, num_blocks=16, block_size=4, kv_heads=1,
                 head_dim=2)
BLOCK_BYTES = 2 * 2 * 4 * 1 * 2 * 4     # K+V, 2 layers, f32


def _tier_state(pool):
    st = _pool_state(pool)
    st["counters"] = {c: getattr(pool, c) for c in TIER_COUNTERS}
    st["host_keys"] = list(pool.host_tier.keys())
    st["stats"] = pool.stats()
    return st


def _jax_buffers(pool):
    return np.stack([np.stack([np.asarray(b) for b in pool.kbufs]),
                     np.stack([np.asarray(b) for b in pool.vbufs])])


def _host_bytes(pool):
    """Each host entry's K and V of every layer, [2, layers, bs, kv, d]."""
    return {key: np.stack([np.stack([np.asarray(a) for a in e.k]),
                           np.stack([np.asarray(a) for a in e.v])])
            for key, e in pool.host_tier._entries.items()}


def _assert_pools_equal(jpool, tpool):
    assert _tier_state(tpool) == _tier_state(jpool)
    np.testing.assert_array_equal(tpool._kv.numpy(), _jax_buffers(jpool))
    th, jh = _host_bytes(tpool), _host_bytes(jpool)
    assert list(th) == list(jh)
    for key in jh:
        np.testing.assert_array_equal(th[key], jh[key])
    jpool.check_invariants()
    tpool.check_invariants()


def _tier_run(jpool, tpool, seed, n_ops=120):
    """A seeded run of pool operations on three 28-token templates over a
    4-token vocabulary, with frequent frees so chains park in the
    starved cached set and spill. The decisions read only the port's
    pool; the two pools are compared after each operation."""
    rng = np.random.RandomState(seed)
    templates = [rng.randint(0, 4, 28).tolist() for _ in range(3)]
    seqs: dict[int, dict] = {}
    next_id = 0
    kinds = ("new", "new", "write", "write", "trim", "free", "free",
             "probe")
    for _ in range(n_ops):
        kind = kinds[rng.randint(len(kinds))]
        if kind == "new" or not seqs:
            if len(seqs) >= 4:
                kind = "free"
            else:
                sid, next_id = next_id, next_id + 1
                tokens = (templates[rng.randint(3)][:rng.randint(2, 28)]
                          + rng.randint(0, 4, rng.randint(0, 5)).tolist())
                ctx = _both(jpool, tpool, "acquire_prefix", sid, tokens,
                            defer_miss=bool(rng.rand() < 0.3))
                _both(jpool, tpool, "take_last_restored")
                seqs[sid] = dict(tokens=tokens, ctx=ctx)
                kind = None
        if kind is not None:
            sid = list(seqs)[rng.randint(len(seqs))]
            s = seqs[sid]
            if kind == "write":
                n = int(rng.randint(1, 9))
                reserve = _both(jpool, tpool, "cow_need", sid, s["ctx"], n)
                got = _both(jpool, tpool, "ensure", sid, s["ctx"] + n,
                            reserve=reserve)
                if got is not None:       # PoolOOM: give the seq up
                    _both(jpool, tpool, "free_seq", sid)
                    del seqs[sid]
                else:
                    _both(jpool, tpool, "prepare_write", sid, s["ctx"], n)
                    s["ctx"] += n
                    while len(s["tokens"]) < s["ctx"]:
                        s["tokens"].append(int(rng.randint(0, 4)))
                    _both(jpool, tpool, "register_prefix_blocks", sid,
                          s["tokens"], s["ctx"])
            elif kind == "trim":
                s["ctx"] = int(rng.randint(0, s["ctx"] + 1))
                _both(jpool, tpool, "trim", sid, s["ctx"] + 1)
            elif kind == "free":
                _both(jpool, tpool, "free_seq", sid)
                del seqs[sid]
            else:
                _both(jpool, tpool, "peek_prefix_tiered", s["tokens"])
                _both(jpool, tpool, "peek_prefix", s["tokens"])
        _assert_pools_equal(jpool, tpool)
    return tpool


TIER_SEEDS = range(4)
# (cached-set cap, host cap in blocks): a roomy host, and one that ages
# entries out
TIER_CONFIGS = [(2, 1 << 10), (1, 5)]


_TIER_RUNS: dict = {}


def _tier_pair_run(seed, cached_cap, host_blocks):
    """Both pools through one seeded run (each run once per module: the
    test of what the runs reach reads the same pools)."""
    key = (seed, cached_cap, host_blocks)
    if key not in _TIER_RUNS:
        _TIER_RUNS[key] = _tier_pair_run_once(*key)
    return _TIER_RUNS[key]


def _tier_pair_run_once(seed, cached_cap, host_blocks):
    rule = "serving.host_tier.restore:after=1:times=2"
    with flags(serving_prefix_cached_blocks=cached_cap,
               serving_host_tier_bytes=host_blocks * BLOCK_BYTES,
               fault_spec=rule):
        jpool = JKVBlockPool(**POOL_GEOM, prefix_cache=True, host_tier=True)
        tpool = KVBlockPool(**POOL_GEOM, device="cpu", prefix_cache=True,
                            host_tier=True)
        data = np.random.RandomState(100 + seed).randn(
            *tpool._kv.shape).astype(np.float32)
        jpool.kbufs = [jnp.asarray(x) for x in data[0]]
        jpool.vbufs = [jnp.asarray(x) for x in data[1]]
        tpool._kv.copy_(torch.from_numpy(data))
        _assert_pools_equal(jpool, tpool)
        return _tier_run(jpool, tpool, seed)


@pytest.mark.parametrize("config", TIER_CONFIGS, ids=["host_roomy",
                                                      "host_capped"])
@pytest.mark.parametrize("seed", TIER_SEEDS)
def test_pool_with_host_tier_matches_jax_pool(seed, config):
    tpool = _tier_pair_run(seed, *config)
    assert tpool.host_tier.spills > 0


@pytest.mark.parametrize("config", TIER_CONFIGS, ids=["host_roomy",
                                                      "host_capped"])
def test_pool_tier_runs_reach_restores_faults_and_evictions(config):
    """What the runs exist for, over the seeds of one config: restores,
    faulted restores, host hits and, with the capped host, evictions."""
    pools = [_tier_pair_run(seed, *config) for seed in TIER_SEEDS]
    assert sum(p.host_tier.restored_blocks for p in pools) > 0
    assert sum(p.host_hits for p in pools) > 0
    assert sum(p.host_restore_failures for p in pools) > 0
    if config[1] < 10:
        assert sum(p.host_tier.evictions for p in pools) > 0


# ---------------------------------------------------------------------------
# (c) export_seq / import_seq
# ---------------------------------------------------------------------------

def _filled_pools(seed=0, **geom):
    g = dict(POOL_GEOM, **geom)
    jpool = JKVBlockPool(**g, prefix_cache=True)
    tpool = KVBlockPool(**g, device="cpu", prefix_cache=True)
    data = np.random.RandomState(seed).randn(*tpool._kv.shape).astype(
        np.float32)
    jpool.kbufs = [jnp.asarray(x) for x in data[0]]
    jpool.vbufs = [jnp.asarray(x) for x in data[1]]
    tpool._kv.copy_(torch.from_numpy(data))
    for pool in (jpool, tpool):
        pool.ensure(7, 4)          # a block to shift the next table
        pool.ensure(3, 10)
    return jpool, tpool


def test_export_import_round_trip_matches_jax():
    """Both packages' manifests have the same keys, sizes and bytes; each
    package imports the other's manifest into byte-equal blocks."""
    jpool, tpool = _filled_pools()
    jm, tm = jpool.export_seq(3, 10), tpool.export_seq(3, 10)
    assert sorted(tm) == sorted(jm)
    for key in ("n_tokens", "blocks", "block_size", "num_layers", "nbytes"):
        assert tm[key] == jm[key], key
    for part in ("k", "v"):
        for a, b in zip(tm[part], jm[part]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jdst, tdst = _filled_pools(seed=1)
    jdst.import_seq(5, tm)             # the port's manifest, JAX pool
    tdst.import_seq(5, jm)             # the JAX manifest, the port's pool
    assert tdst.table(5) == jdst.table(5)
    np.testing.assert_array_equal(tdst._kv.numpy(), _jax_buffers(jdst))
    back = tdst.export_seq(5, 10)
    for part in ("k", "v"):
        for a, b in zip(back[part], tm[part]):
            assert torch.equal(a, b)
    tdst.check_invariants()


@pytest.mark.parametrize("case", ["block_size", "layers", "holds",
                                  "unknown", "too_long"])
def test_export_import_errors_match_jax(case):
    errs = []
    for pool, other in zip(_filled_pools(), _filled_pools(seed=2)):
        man = pool.export_seq(3, 10)
        try:
            if case == "block_size":
                other.import_seq(9, dict(man, block_size=8))
            elif case == "layers":
                other.import_seq(9, dict(man, num_layers=3))
            elif case == "holds":
                other.import_seq(3, man)
            elif case == "unknown":
                pool.export_seq(42, 4)
            else:
                pool.export_seq(3, 13)
        except (ValueError, RuntimeError, KeyError) as e:
            errs.append((type(e).__name__, str(e)))
    assert len(errs) == 2 and errs[0] == errs[1], errs


# ---------------------------------------------------------------------------
# (d) bench.py's zipf-hosttier mix, device / host / cold, both engines
# ---------------------------------------------------------------------------

# bench.py's CPU sizes (bench_serve_host_tier, bench.py:953-957)
HT_REQ, HT_PREFIXES, HT_PREFIX_LEN, HT_SUFFIX, HT_NEW = 12, 3, 32, 6, 4
HT_KNOBS = dict(block_size=4, max_slots=1, prefill_chunk=16)
HT_STARVED = 4


def _hosttier_prompts():
    return _zipf_prompts(np.random.RandomState(7), HT_REQ, HT_PREFIXES,
                         HT_PREFIX_LEN, HT_SUFFIX)


def _device_pool_blocks():
    """bench.py's pool for the ``device`` run: every request's registered
    blocks stay resident, nothing is reclaimed."""
    bs = HT_KNOBS["block_size"]
    return 1 + sum(-(-(len(p) + HT_NEW) // bs) + 1
                   for p in _hosttier_prompts())


# every engine of this module: the device run's pool, more than any
# other case needs (none of them depends on pool pressure)
POOL_BLOCKS = _device_pool_blocks()


def _replay(eng, prompts):
    """bench.py's sequential closed loop: one request at a time."""
    out = []
    for p in prompts:
        rid = eng.add_request(p, max_new_tokens=HT_NEW)
        out.append(eng.run()[rid].output_ids)
    return out


@pytest.fixture(scope="module")
def hosttier_runs(make):
    prompts = _hosttier_prompts()
    bs = HT_KNOBS["block_size"]
    assert HT_PREFIXES * (HT_PREFIX_LEN // bs) > HT_STARVED
    # (cached-set cap, tier); every mode on the device run's pool, so
    # the starved runs differ from it by the cached-set cap alone
    modes = {"device": (0, False), "host": (HT_STARVED, True),
             "cold": (HT_STARVED, False)}
    runs = {}
    for mode, (cached, tier) in modes.items():
        with flags(serving_prefix_cached_blocks=cached):
            engines = make(prefix_cache=True, host_tier=tier, **HT_KNOBS)
            got = []
            for eng in engines:
                outs = _replay(eng, prompts)
                dev, host = eng.pool.peek_prefix_tiered(prompts[0])
                priced = eng._admission.priced_tokens(
                    len(prompts[0]), HT_NEW, dev, host)
                eng.pool.check_invariants()
                got.append(dict(outputs=outs, snap=eng.metrics.snapshot(),
                                peek=(dev, host), priced=priced,
                                health=eng.health()["host_tier"]))
            runs[mode] = got
    return runs


HT_KEYS = ("tokens_computed", "tokens_out", "prefix_hits",
           "prefix_hit_tokens", "prefix_miss_tokens", "host_tier_hits",
           "host_tier_hit_tokens", "host_tier_spills", "host_tier_evictions",
           "host_tier_blocks", "host_tier_bytes", "terminal_reasons")


@pytest.mark.parametrize("mode", ["device", "host", "cold"])
def test_zipf_hosttier_matches_jax_engine(hosttier_runs, mode):
    j, t = hosttier_runs[mode]
    assert t["outputs"] == j["outputs"]
    for k in HT_KEYS:
        assert t["snap"][k] == j["snap"][k], k
    assert t["peek"] == j["peek"] and t["priced"] == j["priced"]
    assert t["health"] == j["health"]


def test_zipf_hosttier_host_restores_what_cold_recomputes(hosttier_runs):
    """bench.py's gates: equal tokens in all three modes; the host run
    computes exactly as much as the device run and the cold run more;
    admission prices device < host < cold."""
    dev, host, cold = (hosttier_runs[m][1]
                       for m in ("device", "host", "cold"))
    assert dev["outputs"] == host["outputs"] == cold["outputs"]
    comp = [r["snap"]["tokens_computed"] for r in (dev, host, cold)]
    assert comp[0] == comp[1] < comp[2], comp
    assert host["snap"]["host_tier_hit_tokens"] > 0
    assert host["health"]["spills"] > 0 and host["health"]["restored_blocks"]
    assert dev["priced"] < host["priced"] < cold["priced"]


# ---------------------------------------------------------------------------
# (e) the robustness cases of tests/test_serving_robustness.py, both engines
# ---------------------------------------------------------------------------

KNOBS = dict(block_size=4, max_slots=2, prefill_chunk=8)


def _chaos_prompts():
    rng = np.random.RandomState(17)
    return [rng.randint(0, 128, (n,)).tolist() for n in (5, 7, 6)]


def _chaos_workload(eng):
    p = _chaos_prompts()
    return [eng.add_request(p[0], max_new_tokens=6),
            eng.add_request(p[1], max_new_tokens=6),
            eng.add_request(p[2], max_new_tokens=5, temperature=0.9,
                            top_k=16, seed=23)]


def _drive(eng):
    done = {}
    while eng.has_work():
        for seq in eng.step():
            done[seq.req_id] = seq
    return done


def _seqs(done):
    return {rid: (s.outcome, s.finish_reason, s.retries, s.output_ids)
            for rid, s in sorted(done.items())}


def _observe(eng, done, **extra):
    eng.pool.check_invariants()
    return dict(seqs=_seqs(done), terminal=dict(eng.metrics.terminal),
                sheds=dict(eng.metrics.sheds),
                step_failures=dict(eng.metrics.step_failures),
                hung=eng.metrics.hung_steps, state=eng.lifecycle.state,
                reason=eng.lifecycle.degraded_reason,
                clean=(eng.pool.num_free + eng.pool.num_cached
                       == eng.pool.num_usable and not eng.requests),
                **extra)


def case_deadline_mid_prefill(eng, api, clock):
    rid = eng.add_request(list(range(1, 14)), max_new_tokens=5,
                          deadline_s=5.0)
    assert eng.step() == [] and eng.requests[rid].ctx == 4
    clock.t += 6.0
    fin = eng.step()
    return _observe(eng, {s.req_id: s for s in fin})


def case_deadline_mid_decode(eng, api, clock):
    eng.add_request([3, 1, 4, 1, 5], max_new_tokens=50, deadline_s=5.0)
    done = {}
    for _ in range(3):
        done.update({s.req_id: s for s in eng.step()})
    clock.t += 6.0
    done.update(_drive(eng))
    return _observe(eng, done)


def case_cancel(eng, api, clock):
    r_run = eng.add_request([3, 1, 4, 1, 5], max_new_tokens=30)
    r_wait = eng.add_request([2, 7, 1], max_new_tokens=30)
    eng.step()
    eng.step()
    states = (eng.requests[r_run].state, eng.requests[r_wait].state)
    done = {r_wait: eng.cancel(r_wait), r_run: eng.cancel(r_run)}
    return _observe(eng, done, states=states,
                    unknown=(eng.cancel(999), eng.cancel(r_run)),
                    table=eng.pool.table(r_run), empty=eng.step())


def case_queue_full(eng, api, clock):
    eng.add_request([1, 2], max_new_tokens=2)
    eng.add_request([1, 2], max_new_tokens=2)
    with pytest.raises(api.RequestRejected) as ei:
        eng.add_request([1, 2], max_new_tokens=2)
    return _observe(eng, _drive(eng),
                    shed=(ei.value.cause, ei.value.reason,
                          isinstance(ei.value, ValueError)))


def case_est_delay(eng, api, clock):
    eng.add_request([1, 2, 3], max_new_tokens=8)         # the backlog
    eng._admission.seed(0.5)                             # 0.5 tokens/s
    causes = []
    for kw in (dict(deadline_s=0.5),
               dict(deadline_s=0.5, arrival_s=clock.t - 1.0)):
        with pytest.raises(api.RequestRejected) as ei:
            eng.add_request([1, 2], max_new_tokens=2, **kw)
        causes.append(ei.value.cause)
    accepted = eng.add_request([1, 2], max_new_tokens=2)
    return _observe(eng, _drive(eng), causes=causes, accepted=accepted,
                    delay=eng._admission.estimated_delay_s(eng.scheduler))


def case_max_context(eng, api, clock):
    with pytest.raises(api.RequestRejected) as ei:
        eng.add_request([1] * eng.max_context, max_new_tokens=1)
    with pytest.raises(ValueError):
        eng.add_request([1, 2], max_new_tokens=2, deadline_s=0.0)
    return _observe(eng, {}, cause=ei.value.cause)


def case_decode_fault(eng, api, clock):
    _chaos_workload(eng)
    return _observe(eng, _drive(eng))


def case_prefill_fault(eng, api, clock):
    eng.add_request(list(range(1, 14)), max_new_tokens=5)
    return _observe(eng, _drive(eng))


def case_sample_fault(eng, api, clock):
    rng = np.random.RandomState(3)
    for n in (5, 6):
        eng.add_request(rng.randint(0, 128, (n,)).tolist(), max_new_tokens=6)
    return _observe(eng, _drive(eng))


def case_two_requests(eng, api, clock):
    eng.add_request([3, 1, 4], max_new_tokens=4)
    eng.add_request([5, 9, 2], max_new_tokens=4)
    return _observe(eng, _drive(eng))


def case_drain(eng, api, clock):
    eng.add_request([3, 1, 4], max_new_tokens=4)
    eng.add_request([5, 9, 2], max_new_tokens=4)
    before = eng.health()["state"]
    done = eng.drain(deadline_s=60.0)
    with pytest.raises(api.RequestRejected) as ei:
        eng.add_request([1, 2], max_new_tokens=2)
    return _observe(eng, done, before=before, cause=ei.value.cause,
                    again=eng.drain())


def case_drain_deadline(eng, api, clock):
    eng.add_request([3, 1, 4, 1, 5], max_new_tokens=80)
    eng.step()
    return _observe(eng, eng.drain(deadline_s=0.0))


def case_hung_step(eng, api, clock):
    rid = eng.add_request([3, 1, 4, 1, 5], max_new_tokens=12)
    clock.tick = 1.0
    with flags(serving_hung_step_s=0.5):
        eng.step()
    states = [(eng.lifecycle.state, eng.lifecycle.degraded_reason)]
    clock.tick = 0.0
    for _ in range(api.RECOVERY_CLEAN_STEPS):
        eng.step()
        states.append((eng.lifecycle.state, eng.lifecycle.degraded_reason))
    eng.cancel(rid)
    eng.drain()
    illegal = []
    for state in ("serving", "draining"):
        with pytest.raises(RuntimeError, match="illegal"):
            eng.lifecycle.to(state)
        illegal.append(state)
    return _observe(eng, {}, states=states, illegal=illegal)


def case_health(eng, api, clock):
    eng.add_request([3, 1, 4], max_new_tokens=2)
    _drive(eng)
    h = eng.health()
    return _observe(eng, {}, keys=sorted(h), health={
        k: v for k, v in h.items() if k not in ("state_since_s",
                                                "last_step_s")})


# name -> (scenario, engine knobs over KNOBS, flags for both packages)
CASES = {
    "deadline_mid_prefill": (case_deadline_mid_prefill,
                             dict(prefill_chunk=4), {}),
    "deadline_mid_decode": (case_deadline_mid_decode, {}, {}),
    "cancel_waiting_running_unknown": (case_cancel, dict(max_slots=1), {}),
    "queue_full": (case_queue_full, {}, dict(serving_max_queue=2)),
    "est_delay": (case_est_delay, {}, {}),
    "max_context_and_deadline_validation": (case_max_context, {}, {}),
    "decode_fault_quarantine": (case_decode_fault, dict(max_slots=1),
                                dict(fault_spec="serving.decode:times=2",
                                     serving_step_retries=1)),
    "prefill_fault_replay": (case_prefill_fault, dict(prefill_chunk=4),
                             dict(fault_spec="serving.prefill:after=1:"
                                  "times=1")),
    "sample_fault_one_row": (case_sample_fault, {},
                             dict(fault_spec="serving.sample:key=1:after=1:"
                                  "times=1")),
    "pool_alloc_fault": (case_two_requests, {},
                         dict(fault_spec="serving.pool_alloc:times=1")),
    "zero_retries": (case_two_requests, dict(max_slots=1),
                     dict(fault_spec="serving.decode:times=1",
                          serving_step_retries=0)),
    "drain": (case_drain, {}, {}),
    "drain_deadline": (case_drain_deadline, {}, {}),
    "hung_step_and_lifecycle": (case_hung_step, {}, {}),
    "health": (case_health, {}, {}),
}


class _Api:
    def __init__(self, rejected, rob):
        self.RequestRejected = rejected
        self.RECOVERY_CLEAN_STEPS = rob.RECOVERY_CLEAN_STEPS


@pytest.fixture(scope="module")
def case_results(make):
    return {}


def _run_case(name, make, clock, results):
    if name in results:
        return results[name]
    scenario, knobs, flag_kw = CASES[name]
    out = []
    with flags(**flag_kw):
        jeng, teng = make(**dict(KNOBS, **knobs))
        for eng, api in ((jeng, _Api(JRequestRejected, jrob)),
                         (teng, _Api(RequestRejected, trob))):
            tfault.reset()
            jfault.reset()
            clock.t, clock.tick = 1000.0, 0.0
            out.append(scenario(eng, api, clock))
    results[name] = out
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_robustness_case_matches_jax_engine(name, make, clock, case_results):
    """Each case on both engines on one fake clock: equal outcomes,
    retries, tokens, counters and lifecycle; the pool is clean."""
    j, t = _run_case(name, make, clock, case_results)
    if name == "health":
        # the port's health() has the reference's keys; its attend stamp
        # names the device's choice where the JAX engine names its
        # kernel plan (here its plain reference)
        assert (t["health"]["paged_kernel"],
                j["health"]["paged_kernel"]) == ("plain", "reference")
        j = dict(j, health=dict(j["health"], paged_kernel="plain"))
    assert t == j
    assert t["clean"]


EXPECTED = {
    "deadline_mid_prefill": lambda r: (
        list(r["seqs"].values()) == [("expired", "expired", 0, [])]
        and r["terminal"] == {"expired": 1}),
    "deadline_mid_decode": lambda r: (
        [s[0] for s in r["seqs"].values()] == ["expired"]
        and len(list(r["seqs"].values())[0][3]) >= 1),
    "cancel_waiting_running_unknown": lambda r: (
        r["states"] == ("running", "waiting")
        and r["terminal"] == {"cancelled": 2} and r["table"] == []
        and r["unknown"] == (None, None) and r["empty"] == []
        and r["seqs"][1][3] == [] and len(r["seqs"][0][3]) >= 1),
    "queue_full": lambda r: (
        r["shed"] == ("queue_full", "shed", True)
        and r["sheds"] == {"queue_full": 1}
        and r["terminal"] == {"shed": 1, "ok": 2}),
    "est_delay": lambda r: (
        r["causes"] == ["est_delay", "est_delay"]
        and r["sheds"] == {"est_delay": 2}
        and r["terminal"] == {"shed": 2, "ok": 2}),
    "max_context_and_deadline_validation": lambda r: (
        r["cause"] == "max_context" and r["sheds"] == {"max_context": 1}),
    "decode_fault_quarantine": lambda r: (
        [s[0] for s in r["seqs"].values()] == ["failed", "ok", "ok"]
        and r["seqs"][0][2] == 2 and r["step_failures"] == {"decode": 2}
        and r["terminal"] == {"failed": 1, "ok": 2}),
    "prefill_fault_replay": lambda r: (
        list(r["seqs"].values())[0][:3] == ("ok", "length", 1)
        and r["step_failures"] == {"prefill": 1}),
    "sample_fault_one_row": lambda r: (
        [s[:3] for s in r["seqs"].values()] == [("ok", "length", 0),
                                                ("ok", "length", 1)]
        and r["step_failures"] == {"decode": 1}),
    "pool_alloc_fault": lambda r: (
        [s[:3] for s in r["seqs"].values()] == [("ok", "length", 0)] * 2
        and r["step_failures"] == {"schedule": 1}),
    "zero_retries": lambda r: (
        [s[:3] for s in r["seqs"].values()] == [("failed", "failed", 1),
                                                ("ok", "length", 0)]),
    "drain": lambda r: (
        r["before"] == "serving" and r["state"] == "stopped"
        and r["cause"] == "draining" and r["again"] == {}
        and [s[0] for s in r["seqs"].values()] == ["ok", "ok"]),
    "drain_deadline": lambda r: (
        [s[0] for s in r["seqs"].values()] == ["cancelled"]
        and r["state"] == "stopped"),
    "hung_step_and_lifecycle": lambda r: (
        r["states"][0] == ("degraded", "hung_step") and r["hung"] == 1
        and r["states"][-2][0] == "degraded"
        and r["states"][-1] == ("serving", None)
        and r["state"] == "stopped"),
    "health": lambda r: (
        r["health"]["state"] == "serving"
        and r["health"]["terminal_reasons"] == {"ok": 1}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_robustness_case_reaches_its_contract(name, make, clock,
                                              case_results):
    """Each case reaches what the JAX package's test asserts (so the
    equality above is not vacuous)."""
    _, t = _run_case(name, make, clock, case_results)
    assert EXPECTED[name](t), t


def test_faulted_runs_keep_fault_free_tokens(make, clock, case_results):
    """Survivors of a quarantine, a replayed prefill and a replayed sample
    row emit the fault-free tokens."""
    results = {}
    for name, scenario, knobs in (
            ("decode", case_decode_fault, dict(max_slots=1)),
            ("prefill", case_prefill_fault, dict(prefill_chunk=4)),
            ("sample", case_sample_fault, {})):
        with flags():
            _, teng = make(**dict(KNOBS, **knobs))
            results[name] = scenario(teng, _Api(RequestRejected, trob),
                                     clock)["seqs"]
    faulted = {n: _run_case(c, make, clock, case_results)[1]["seqs"]
               for n, c in (("decode", "decode_fault_quarantine"),
                            ("prefill", "prefill_fault_replay"),
                            ("sample", "sample_fault_one_row"))}
    for name, ref in results.items():
        for rid, seq in faulted[name].items():
            if seq[0] == "ok":
                assert seq[3] == ref[rid][3], (name, rid)


# ---------------------------------------------------------------------------
# (f) speculation faults degrade to plain decode (the reference's red test)
# ---------------------------------------------------------------------------

SPEC_KNOBS = dict(block_size=4, max_slots=4, prefill_chunk=32,
                  token_budget=64, spec="ngram")


@pytest.fixture(scope="module")
def spec_prompts(models):
    return _cycling_prompts(models[1])


def _spec_run(tm, prompts, spec):
    with flags(fault_spec=spec):
        eng = ServingEngine.from_model(tm, device="cpu", **SPEC_KNOBS)
        rids = [eng.add_request(p, max_new_tokens=10) for p in prompts]
        done = _drive(eng)
    return [done[r] for r in rids], eng


@pytest.mark.parametrize("site", ["serving.spec.propose",
                                  "serving.spec.verify"])
def test_spec_fault_degrades_to_plain_decode_not_quarantine(
        models, spec_prompts, site, monkeypatch):
    """A fault at either speculation site degrades EXACTLY that sequence
    to plain decode: one report at the site and none elsewhere, outcome
    ok, no retry, no step failure, the lifecycle stays SERVING, and the
    tokens equal the fault-free speculative run. First the premise the
    JAX package's version of this test misses: drafts are accepted."""
    tm = models[1]
    ref, ref_eng = _spec_run(tm, spec_prompts, "")
    assert ref_eng.metrics.spec_accepted > 0
    reports = []
    monkeypatch.setattr(trob, "_report_degraded",
                        lambda s, e: reports.append(s))
    got, eng = _spec_run(tm, spec_prompts, f"{site}:times=1")
    assert reports == [site]
    assert sum(s.spec_off for s in got) == 1
    for seq, rseq in zip(got, ref):
        assert (seq.outcome, seq.retries) == ("ok", 0)
        assert seq.output_ids == rseq.output_ids
    assert eng.metrics.step_failures == {}
    assert eng.metrics.terminal == {"ok": len(spec_prompts)}
    assert eng.lifecycle.state == "serving"
    eng.pool.check_invariants()


@pytest.mark.parametrize("name", [
    "serving_host_tier", "serving_host_tier_bytes",
    "serving_host_tier_restore_frac", "serving_max_queue",
    "serving_step_retries", "serving_hung_step_s",
    "serving_prefix_min_blocks", "serving_drain_timeout_s", "fault_spec"])
def test_new_flags_default_and_type_as_jax(name):
    from paddle_tpu import flags as jflags
    jf, tf = jflags._REGISTRY[name], tflags._REGISTRY[name]
    assert (tf.default, tf.type) == (jf.default, jf.type)
