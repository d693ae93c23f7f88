"""Llama serving in the PyTorch port against the JAX package.

A tiny Llama is built in the JAX package, its state dict is carried into
the port with ``load_reference_state``, and both run the same prompts:
paged cached-forward logits agree in f32, and greedy and seeded
top-k/top-p tokens agree exactly (sampling is host-side numpy in both
engines). Everything runs on the CPU, where the port takes the plain
versions of its kernels.
"""

import numpy as np
import pytest
import torch

# the JAX package is the oracle here; a machine without it (the card's)
# runs only the gpu-marked tests of the other test_torch_* modules
jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as pt
from paddle_tpu.models import LlamaConfig as JLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JLlamaForCausalLM
from paddle_tpu.serving import PagedLayerCache as JPagedLayerCache
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch import (LlamaConfig, LlamaForCausalLM, ServingEngine,
                              load_reference_state)
from paddle_tpu_torch.serving import PagedLayerCache
from torch_threads import one_torch_thread  # noqa: F401

GEOM = dict(num_hidden_layers=2, num_key_value_heads=2,
            max_position_embeddings=96)


@pytest.fixture(autouse=True)
def _jax_plain_attention():
    """The JAX side runs its plain paged attention: the Pallas kernel's
    own parity is held in tests/test_torch_kernels.py and
    tests/test_paged_kernel.py, and interpret mode is slow."""
    before = pt.get_flags("serving_paged_kernel")["serving_paged_kernel"]
    pt.set_flags({"serving_paged_kernel": "reference"})
    yield
    pt.set_flags({"serving_paged_kernel": before})


def _pair(**extra):
    """A tiny JAX Llama and the port's copy of it."""
    pt.seed(11)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**GEOM, **extra))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig.tiny(**GEOM, **extra), device="cpu")
    load_reference_state(tm, {k: np.asarray(v.numpy())
                              for k, v in jm.state_dict().items()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)).tolist() for n in lengths]


def test_load_reference_state_rejects_bad_names_and_shapes(models):
    jm, _ = models
    arrays = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = LlamaForCausalLM(LlamaConfig.tiny(**GEOM), device="cpu")
    with pytest.raises(KeyError):
        load_reference_state(tm, {**arrays, "llama.extra.weight": arrays[
            "lm_head.weight"]})
    missing = dict(arrays)
    del missing["llama.norm.weight"]
    with pytest.raises(KeyError):
        load_reference_state(tm, missing)
    with pytest.raises(ValueError):
        load_reference_state(tm, {**arrays, "lm_head.weight":
                                  arrays["lm_head.weight"].T})


def test_paged_cached_forward_logits_match_jax(models):
    """A ragged prefill (two rows, one padded) then a decode step over
    paged caches: the port's logits equal the JAX model's to 1e-5."""
    jm, tm = models
    cfg = tm.config
    kv, d = cfg.num_key_value_heads, cfg.hidden_size // cfg.num_attention_heads
    bs, max_blocks, nb = 4, 4, 9
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    ids = np.asarray(_prompts(2, [8, 8]), np.int32)
    steps = [(ids, [0, 0], [8, 5]),
             (np.asarray([[3], [9]], np.int32), [8, 5], [1, 1])]
    jbufs = [(jnp.zeros((nb, bs, kv, d)), jnp.zeros((nb, bs, kv, d)))
             for _ in range(cfg.num_hidden_layers)]
    tbufs = [(torch.zeros(nb, bs, kv, d), torch.zeros(nb, bs, kv, d))
             for _ in range(cfg.num_hidden_layers)]
    for step_ids, pos, lens in steps:
        pos, lens = np.asarray(pos, np.int32), np.asarray(lens, np.int32)
        jc = [JPagedLayerCache(k, v, jnp.asarray(tables), jnp.asarray(lens))
              for k, v in jbufs]
        jlog, jc = jm(pt.to_tensor(step_ids), kv_caches=jc,
                      position_offset=jnp.asarray(pos))
        jbufs = [(c.kbuf, c.vbuf) for c in jc]
        tc = [PagedLayerCache(k, v, torch.from_numpy(tables),
                              torch.from_numpy(lens)) for k, v in tbufs]
        with torch.no_grad():
            tlog, _ = tm(torch.from_numpy(step_ids), kv_caches=tc,
                         position_offset=torch.from_numpy(pos))
        for b, n in enumerate(lens):
            np.testing.assert_allclose(tlog[b, :n].numpy(),
                                       np.asarray(jlog.numpy())[b, :n],
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tied", [False, True])
def test_generate_greedy_matches_jax(models, tied):
    """Dense-cache greedy decoding, with a separate LM head and with
    the head tied to the embedding (the JAX state dict lists a tied
    weight once)."""
    jm, tm = _pair(tie_word_embeddings=True) if tied else models
    for p in _prompts(4, [5, 11]):
        want = jm.generate(pt.to_tensor(np.asarray([p], np.int32)),
                           max_new_tokens=7).numpy()[0, len(p):].tolist()
        got = tm.generate(torch.tensor([p]), max_new_tokens=7)
        assert got[0, len(p):].tolist() == want


def test_cacheless_forward_raises_until_training_slice(models):
    """The training slice ported the cache-less forward: it returns the
    logits; since slice 17 ``recompute`` (per-layer checkpointing) runs
    too, and gives the same logits. Its parity with the JAX package is in
    test_torch_llama_training.py and test_torch_training_surface.py."""
    _, tm = models
    ids = torch.zeros(1, 4, dtype=torch.long)
    with torch.no_grad():
        logits = tm(ids)
    assert logits.shape == (1, 4, tm.config.vocab_size)
    tm.config.recompute = True
    try:
        assert torch.equal(tm(ids), logits)
    finally:
        tm.config.recompute = False


ENGINE_CASES = {
    # mixed prompt lengths sharing the decode batch
    "mixed_lengths": (dict(block_size=4, max_slots=4, prefill_chunk=16),
                      (5, 9, 7, 13), 6),
    # prompts longer than the chunk prefill over several steps
    "chunked_prefill": (dict(block_size=4, max_slots=4, prefill_chunk=4),
                        (13, 6, 9), 7),
    # two 16-token sequences cannot coexist in 6 usable blocks: the
    # newer one is preempted and recomputed
    "preemption": (dict(block_size=4, max_slots=4, prefill_chunk=8,
                        pool_blocks=7), (8, 8), 8),
}


def _run_both(models, kw, requests):
    """Run the same requests through the JAX and the port's engine;
    returns both engines and {request index: (jax tokens, port tokens)}."""
    jm, tm = models
    jeng = JServingEngine.from_model(jm, prefix_cache=False, **kw)
    teng = ServingEngine.from_model(tm, device="cpu", prefix_cache=False,
                                    **kw)
    jids = [jeng.add_request(p, **r) for p, r in requests]
    tids = [teng.add_request(p, **r) for p, r in requests]
    jdone, tdone = jeng.run(), teng.run()
    pairs = {i: (jdone[j].output_ids, tdone[t].output_ids)
             for i, (j, t) in enumerate(zip(jids, tids))}
    return jeng, teng, pairs


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_greedy_matches_jax_engine(models, case):
    kw, lengths, n_new = ENGINE_CASES[case]
    requests = [(p, dict(max_new_tokens=n_new))
                for p in _prompts(len(lengths), lengths)]
    jeng, teng, pairs = _run_both(models, kw, requests)
    for i, (want, got) in pairs.items():
        assert got == want, f"request {i}"
        assert len(got) == n_new
    if case == "preemption":
        assert teng.metrics.preemptions >= 1
        assert jeng.metrics.snapshot()["preemptions"] >= 1
    teng.pool.check_invariants()
    assert teng.pool.num_free == teng.pool.num_usable


def test_engine_seeded_sampling_matches_jax_engine(models):
    """Top-k and top-p requests draw the same tokens: both engines
    sample host-side from np.random.default_rng(seed)."""
    p1, p2, p3 = _prompts(9, (6, 10, 4))
    requests = [(p1, dict(max_new_tokens=8, temperature=0.9, top_k=8,
                          seed=1)),
                (p2, dict(max_new_tokens=8, temperature=1.1, top_p=0.8,
                          seed=2)),
                (p3, dict(max_new_tokens=8, temperature=0.7, top_k=20,
                          top_p=0.9, seed=3))]
    _, _, pairs = _run_both(
        models, dict(block_size=4, max_slots=4, prefill_chunk=8), requests)
    for i, (want, got) in pairs.items():
        assert got == want, f"request {i}"
