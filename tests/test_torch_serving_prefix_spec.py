"""Serving's prefix cache (refcounts, radix index, copy-on-write) and
speculative decoding (n-gram and draft-model proposers) in the PyTorch
port, against the JAX package.

- The port's ``KVBlockPool`` and the JAX one take the same seeded runs
  of 200 operations (8 seeds, 3 caps on the cached set); after each
  operation, tables, refcounts, the cached LRU order, the free list, the
  index, counters and copy-on-write pairs are equal, and both pools pass
  ``check_invariants``.
- The port's engine and the JAX engine serve the same shared-prefix mix
  (Zipf over system prompts, an exact resubmit, a pool small enough to
  preempt) with caching on, and speculative mixes under ``spec="ngram"``
  and ``spec="draft"``: tokens, prefix and speculation counters and
  dispatch counts are equal.
- Speculation is lossless in the port itself: spec on equals spec off,
  greedy and seeded stochastic, and a request that finishes inside an
  accepted burst leaves as many cached blocks as with spec off.

Tokens and counters are compared exactly. Everything runs on the CPU,
where the port takes the plain versions of its kernels; the JAX side runs
its plain paged attention (the kernels' own parity is held in
tests/test_torch_kernels.py).
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as pt
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.serving import KVBlockPool as JKVBlockPool
from paddle_tpu.serving import PoolOOM as JPoolOOM
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch import (LlamaConfig, LlamaForCausalLM, ServingEngine,
                              load_reference_state)
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.serving import KVBlockPool, PoolOOM
from torch_threads import one_torch_thread  # noqa: F401

# one layer keeps the JAX engines' compiles short
GEOM = dict(num_hidden_layers=1, num_key_value_heads=2,
            max_position_embeddings=96)
# a port-only draft model: another width, head size and grouping than the
# target (its buffers take its own geometry); against the JAX engine the
# target drafts for itself, so that drafts are accepted
DRAFT_GEOM = dict(num_hidden_layers=1, hidden_size=32, intermediate_size=64,
                  num_attention_heads=4, num_key_value_heads=1,
                  max_position_embeddings=96)


@pytest.fixture(scope="module", autouse=True)
def _jax_plain_attention():
    """The JAX side runs its plain paged attention (interpret-mode Pallas
    is slow). Module-scoped, so that the module-scoped runs below, which
    are set up before any function-scoped fixture, see it."""
    before = pt.get_flags("serving_paged_kernel")["serving_paged_kernel"]
    pt.set_flags({"serving_paged_kernel": "reference"})
    yield
    pt.set_flags({"serving_paged_kernel": before})


def _pair(seed, **geom):
    """A tiny JAX Llama and the port's copy of it."""
    pt.seed(seed)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**geom))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(**geom), device="cpu")
    load_reference_state(tm, {k: np.asarray(v.numpy())
                              for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair(11, **GEOM)


# ---------------------------------------------------------------------------
# (a) the pool, operation by operation
# ---------------------------------------------------------------------------

POOL_COUNTERS = ("allocs", "frees", "oom_events", "prefix_hits",
                 "prefix_hit_tokens", "prefix_miss_tokens", "cow_copies",
                 "cached_evictions")


def _pool_state(pool):
    return dict(tables={k: list(v) for k, v in pool._tables.items()},
                ref=dict(pool._ref), cached=list(pool._cached),
                free=list(pool._free), index=dict(pool._index),
                registered=dict(pool._registered),
                counters={c: getattr(pool, c) for c in POOL_COUNTERS})


def _both(jpool, tpool, name, *args, **kw):
    """Call ``name`` on both pools: equal results, or PoolOOM (or the
    same other error) from both. Returns the port's result, or the
    exception class."""
    out = []
    for pool, oom in ((jpool, JPoolOOM), (tpool, PoolOOM)):
        try:
            out.append(getattr(pool, name)(*args, **kw))
        except oom:
            out.append(PoolOOM)
        except RuntimeError as e:
            out.append(type(e).__name__)
    assert out[0] == out[1], (name, args, kw, out)
    return out[1]


def _pool_run(jpool, tpool, seed, n_ops=200):
    """A seeded run of pool operations as an engine would make them, on
    a small pool (reclaim and OOM under pressure) and a 4-token vocabulary
    of prompt templates (prefix hits). The decisions read only the port's
    pool; the two pools are equal after each operation."""
    rng = np.random.RandomState(seed)
    templates = [rng.randint(0, 4, 28).tolist() for _ in range(3)]
    seqs: dict[int, dict] = {}
    next_id = 0
    kinds = ("new", "write", "write", "write", "trim", "free", "probe")
    for _ in range(n_ops):
        kind = kinds[rng.randint(len(kinds))]
        if kind == "new" or not seqs:
            if len(seqs) >= 6:
                kind = "free"
            else:
                sid, next_id = next_id, next_id + 1
                tokens = (templates[rng.randint(3)][:rng.randint(2, 28)]
                          + rng.randint(0, 4, rng.randint(0, 5)).tolist())
                ctx = _both(jpool, tpool, "acquire_prefix", sid, tokens,
                            defer_miss=bool(rng.rand() < 0.3))
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
                if got is PoolOOM:
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
                _both(jpool, tpool, "can_extend", sid, s["ctx"] + 5,
                      reserve=1)
                _both(jpool, tpool, "peek_prefix", s["tokens"])
        assert _pool_state(tpool) == _pool_state(jpool)
        jpool.check_invariants()
        tpool.check_invariants()
    return tpool


POOL_SEEDS = range(8)
# 0: the cached set unbounded; 1 and 3: the LRU cap evicts too
POOL_CAPS = (0, 1, 3)


def _pool_pair_run(seed, cached_cap):
    """Both pools through one seeded run with ``serving_prefix_cached_
    blocks`` at ``cached_cap`` in both packages; returns the port's."""
    before = pt.get_flags("serving_prefix_cached_blocks")
    tflags.set_flags({"serving_prefix_cached_blocks": cached_cap})
    pt.set_flags({"serving_prefix_cached_blocks": cached_cap})
    try:
        geom = dict(num_layers=1, num_blocks=16, block_size=4, kv_heads=1,
                    head_dim=2)
        jpool = JKVBlockPool(**geom, prefix_cache=True)
        tpool = KVBlockPool(**geom, device="cpu", prefix_cache=True)
        return _pool_run(jpool, tpool, seed)
    finally:
        tflags.set_flags({"serving_prefix_cached_blocks": 0})
        pt.set_flags(before)


@pytest.mark.parametrize("cached_cap", POOL_CAPS)
@pytest.mark.parametrize("seed", POOL_SEEDS)
def test_pool_operations_match_jax_pool(seed, cached_cap):
    """Every operation of a seeded run leaves both pools in the same
    state; every run hits prefixes and reclaims cached blocks."""
    tpool = _pool_pair_run(seed, cached_cap)
    assert tpool.prefix_hits > 0 and tpool.cached_evictions > 0


@pytest.mark.parametrize("cached_cap", POOL_CAPS)
def test_pool_runs_reach_copy_on_write_and_refused_allocations(cached_cap):
    """What the runs exist for, over the seeds of one cap: copies on
    write into shared blocks and allocations the pool refuses."""
    pools = [_pool_pair_run(seed, cached_cap) for seed in POOL_SEEDS]
    assert sum(p.cow_copies for p in pools) > 0
    assert sum(p.oom_events for p in pools) > 0


def test_pool_defaults_to_prefix_cache_and_refuses_host_tier():
    """The prefix cache is on and the host tier off by default; the pool
    refuses the tier (builds none) without the prefix cache, as the JAX
    pool does."""
    geom = dict(num_layers=1, num_blocks=4, block_size=4, kv_heads=1,
                head_dim=2, device="cpu")
    pool = KVBlockPool(**geom)
    assert pool.prefix_cache is True and pool.host_tier is None
    assert KVBlockPool(**geom, prefix_cache=False,
                       host_tier=True).host_tier is None
    assert KVBlockPool(**geom, host_tier=True).host_tier is not None


# ---------------------------------------------------------------------------
# (b) the engine with caching on, against the JAX engine
# ---------------------------------------------------------------------------

def _zipf_prompts(rng, n_req, n_prefixes, prefix_len, suffix_max,
                  alpha=1.2):
    """Shared-prefix requests as bench.py's ``_zipf_prompts`` makes them:
    each picks a system prompt by Zipf popularity and appends a short
    unique suffix."""
    prefixes = [rng.randint(0, 128, (prefix_len,)).tolist()
                for _ in range(n_prefixes)]
    probs = np.arange(1, n_prefixes + 1, dtype=np.float64) ** -alpha
    probs /= probs.sum()
    out = []
    for _ in range(n_req):
        k = int(rng.choice(n_prefixes, p=probs))
        out.append(prefixes[k] + rng.randint(
            0, 128, (int(rng.randint(1, suffix_max + 1)),)).tolist())
    return out


def _shared_prefix_requests():
    """Zipf over 3 system prompts of 12 tokens with 1-4 token suffixes;
    the first prompt is cut to 16 tokens and resubmitted exactly right
    after it, so the copy's capped hit (15 tokens) lands inside a block
    the original still holds: a copy-on-write. Every third request
    samples (seeded top-k/top-p)."""
    rng = np.random.RandomState(3)
    prompts = _zipf_prompts(rng, 9, 3, 12, 4)
    prompts[0] = (prompts[0] + [1, 2, 3, 4])[:16]
    prompts.insert(1, list(prompts[0]))
    reqs = []
    for i, p in enumerate(prompts):
        kw = dict(max_new_tokens=6)
        if i % 3 == 2:
            kw.update(temperature=0.8, top_k=20, top_p=0.9, seed=i)
        reqs.append((p, kw))
    return reqs


def _counting(engine, names):
    """Count calls of the engine's dispatch methods: {name: count}."""
    counts = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(engine, name)

        def wrapped(*a, _fn=fn, _name=name):
            counts[_name] += 1
            return _fn(*a)
        setattr(engine, name, wrapped)
    return counts


SNAP_KEYS = ("prefix_hits", "prefix_hit_tokens", "prefix_miss_tokens",
             "cow_copies", "preemptions", "tokens_computed", "tokens_out",
             "spec_proposed", "spec_accepted")


def _serve_both(models, requests, *, draft=None, **kw):
    """The same requests through the JAX and the port's engine (the
    port's with its default prefix cache unless ``kw`` says otherwise):
    outputs in request order, metrics snapshots, dispatch counts, and
    the port's engine."""
    jm, tm = models
    jd, td = draft if draft is not None else (None, None)
    jeng = JServingEngine.from_model(jm, draft_model=jd, **kw)
    teng = ServingEngine.from_model(tm, device="cpu", draft_model=td, **kw)
    names = ["_dispatch"] + (["_dispatch_full"] if kw.get("spec") else [])
    jcount = _counting(jeng, names)
    jids = [jeng.add_request(p, **r) for p, r in requests]
    tids = [teng.add_request(p, **r) for p, r in requests]
    jdone, tdone = jeng.run(), teng.run()
    jeng.pool.check_invariants()
    teng.pool.check_invariants()
    return dict(
        jax=[jdone[i].output_ids for i in jids],
        port=[tdone[i].output_ids for i in tids],
        jsnap=jeng.metrics.snapshot(), tsnap=teng.metrics.snapshot(),
        jdispatch=sum(jcount.values()),
        jverify=jcount.get("_dispatch_full", 0), engine=teng,
        jcached=jeng.pool.num_cached)


PREFIX_KNOBS = dict(block_size=4, max_slots=3, prefill_chunk=4,
                    pool_blocks=14)


@pytest.fixture(scope="module")
def prefix_run(models):
    return _serve_both(models, _shared_prefix_requests(), **PREFIX_KNOBS,
                       prefix_cache=True)


def test_engine_defaults_to_prefix_cache_and_spec_off(models):
    _, tm = models
    eng = ServingEngine.from_model(tm, device="cpu", block_size=4)
    assert eng.pool.prefix_cache is True and eng.spec_mode == "off"
    assert eng.pool.host_tier is None and eng.health()["host_tier"] is None
    eng = ServingEngine.from_model(tm, device="cpu", host_tier=True)
    assert eng.health()["host_tier"]["entries"] == 0


@pytest.mark.parametrize("what", ["outputs", "counters", "dispatches",
                                  "exercised"])
def test_engine_prefix_cache_matches_jax_engine(prefix_run, what):
    """The shared-prefix mix with caching on, greedy and seeded: equal
    tokens, prefix/preemption counters and dispatches; and the run hits,
    copies on write and preempts."""
    r = prefix_run
    if what == "outputs":
        assert r["port"] == r["jax"]
    elif what == "counters":
        for k in SNAP_KEYS:
            assert r["tsnap"][k] == r["jsnap"][k], k
        assert r["engine"].pool.num_cached == r["jcached"]
    elif what == "dispatches":
        assert r["engine"].dispatches == r["jdispatch"]
    else:
        s = r["tsnap"]
        assert s["prefix_hits"] > 0 and s["cow_copies"] > 0
        assert s["preemptions"] > 0


def test_engine_prefix_cache_on_equals_off(models, prefix_run):
    """Caching moves no token: the port's engine with caching off gives
    the same outputs as with it on, and computes more tokens."""
    _, tm = models
    eng = ServingEngine.from_model(tm, device="cpu", **PREFIX_KNOBS,
                                   prefix_cache=False)
    reqs = _shared_prefix_requests()
    rids = [eng.add_request(p, **r) for p, r in reqs]
    done = eng.run()
    assert [done[i].output_ids for i in rids] == prefix_run["port"]
    snap = eng.metrics.snapshot()
    assert snap["prefix_hits"] == 0
    assert snap["tokens_computed"] > prefix_run["tsnap"]["tokens_computed"]


# ---------------------------------------------------------------------------
# (c) speculative decoding, against the JAX engine and against spec off
# ---------------------------------------------------------------------------

def _repeat_heavy_requests(seed=4, n=5, stochastic=(1, 3)):
    """bench.py's repeat-heavy shape at tiny size: a 4-token pattern
    tiled 3 or 4 times (whole prefill chunks, so the JAX engine compiles
    few shapes); the listed requests sample (seeded)."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(n):
        pat = rng.randint(0, 128, (4,)).tolist()
        p = pat * int(rng.randint(3, 5))
        kw = dict(max_new_tokens=10)
        if i in stochastic:
            kw.update(temperature=0.7, top_k=8, seed=10 + i)
        reqs.append((p, kw))
    return reqs


SPEC_KNOBS = dict(block_size=4, max_slots=3, prefill_chunk=4,
                  token_budget=24)


@pytest.fixture(scope="module")
def spec_runs(models):
    return {mode: _serve_both(models, _repeat_heavy_requests(), spec=mode,
                              draft=models if mode == "draft" else None,
                              **SPEC_KNOBS)
            for mode in ("ngram", "draft")}


@pytest.mark.parametrize("what", ["outputs", "counters", "dispatches"])
@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_engine_speculation_matches_jax_engine(spec_runs, mode, what):
    r = spec_runs[mode]
    if what == "outputs":
        assert r["port"] == r["jax"]
    elif what == "counters":
        for k in SNAP_KEYS:
            assert r["tsnap"][k] == r["jsnap"][k], k
        assert r["tsnap"]["spec_accepted"] > 0
    else:
        assert r["engine"].dispatches == r["jdispatch"]
        assert r["engine"].verify_dispatches == r["jverify"] > 0


def _port_outputs(tm, **kw):
    eng = ServingEngine.from_model(tm, device="cpu", **SPEC_KNOBS, **kw)
    rids = [eng.add_request(p, **r) for p, r in _repeat_heavy_requests()]
    done = eng.run()
    eng.pool.check_invariants()
    return eng, [done[i].output_ids for i in rids]


@pytest.mark.parametrize("mode", ["ngram", "draft", "draft_other_geometry"])
def test_engine_speculation_equals_spec_off(models, spec_runs, mode):
    """Lossless in the port itself: the spec-off engine gives the same
    tokens, greedy and seeded stochastic alike; so does a draft model of
    another geometry (random weights, so its drafts are mostly
    rejected), whose proposer steps its own model and buffers."""
    _, tm = models
    off, want = _port_outputs(tm, spec="off")
    assert off.verify_dispatches == 0
    if mode in spec_runs:
        assert spec_runs[mode]["port"] == want
        return
    draft = LlamaForCausalLM(LlamaConfig.tiny(**DRAFT_GEOM), device="cpu",
                             seed=5)
    eng, got = _port_outputs(tm, spec="draft", draft_model=draft)
    assert got == want
    prop = eng._proposer
    assert prop.dispatches > 0 and eng.verify_dispatches > 0
    assert tuple(prop.kbufs[0].shape[2:]) == (1, 8)


def test_engine_spec_requires_a_draft_model_and_a_lookahead(models):
    _, tm = models
    with pytest.raises(ValueError, match="draft model"):
        ServingEngine.from_model(tm, device="cpu", spec="draft")
    with pytest.raises(ValueError, match="want one of"):
        ServingEngine.from_model(tm, device="cpu", spec="medusa")
    tflags.set_flags({"serving_spec_lookahead": 0})
    try:
        with pytest.raises(ValueError, match="lookahead must be >= 1"):
            ServingEngine.from_model(tm, device="cpu", spec="ngram")
    finally:
        tflags.set_flags({"serving_spec_lookahead": 4})


# ---------------------------------------------------------------------------
# (d) a request that finishes inside an accepted burst
# ---------------------------------------------------------------------------

def _cycling_prompts(tm, n=2):
    """Prompts on which the tiny model's greedy continuation repeats
    itself: each is a seeded prompt followed by 24 of the model's own
    greedy tokens, by which point its output has settled into a cycle,
    so the n-gram proposer's drafts are accepted."""
    rng = np.random.RandomState(4)
    out = []
    for _ in range(n):
        p = rng.randint(0, 128, (6,)).tolist()
        out.append(tm.generate(torch.tensor([p]),
                               max_new_tokens=24)[0].tolist())
    return out


def test_finishing_burst_registers_prefix_blocks(models):
    """Registration runs before emission on the verify path too: a
    request that finishes inside an accepted burst leaves its final full
    blocks in the prefix index, so spec on caches as many blocks as spec
    off. The run first shows that drafts were accepted, which the JAX
    package's test of this contract does not reach with its prompts."""
    _, tm = models
    prompts = _cycling_prompts(tm)
    cached, outs, steps = {}, {}, {}
    for spec in ("off", "ngram"):
        eng = ServingEngine.from_model(tm, device="cpu", block_size=4,
                                       max_slots=4, prefill_chunk=32,
                                       spec=spec, token_budget=64)
        rids = [eng.add_request(p, max_new_tokens=5) for p in prompts]
        done = eng.run()
        if spec == "ngram":
            # drafts were accepted, several in one step
            assert eng.metrics.spec_accepted > 0
            assert max(eng.metrics.spec_step_tokens.samples) >= 2
        cached[spec] = eng.pool.num_cached
        outs[spec] = [done[r].output_ids for r in rids]
        steps[spec] = eng.metrics.steps
        eng.pool.check_invariants()
    assert outs["ngram"] == outs["off"]
    # 1 prefill + 4 decode steps with spec off; with it on the requests
    # ended in bursts of several tokens, capped by max_new_tokens
    assert steps["ngram"] < steps["off"]
    assert cached["ngram"] == cached["off"], cached
