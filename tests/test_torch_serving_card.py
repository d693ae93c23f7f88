"""The port's serving engine on the card, with the prefix cache and with
speculative decoding, against dense ``generate``; and the host-RAM tier's
spill and restore of a bf16 block on the card.

A 2-layer f32 Llama (head_dim 128, so K5 and K6 take the kernels) serves a
shared-prefix set with caching on, one prompt resubmitted right after
itself so that its prefill copies a shared block on write, and a
repeat-heavy set under n-gram speculation; greedy tokens must equal dense
``generate`` token for token. The tests are marked ``gpu`` and skip on a
machine without a CUDA device; this module imports no JAX.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import LlamaConfig, LlamaForCausalLM, ServingEngine
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.distributed import fault
from paddle_tpu_torch.serving import KVBlockPool

VOCAB = 256


@pytest.fixture(scope="module")
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=VOCAB, hidden_size=512,
                      intermediate_size=1024, num_hidden_layers=2,
                      num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=512)
    return LlamaForCausalLM(cfg, seed=3)


def _dense(model, prompt, n_new):
    ids = torch.tensor([prompt], device="cuda")
    return model.generate(ids, max_new_tokens=n_new)[0, len(prompt):].tolist()


def _serve(engine, prompts, n_new):
    rids = [engine.add_request(p, max_new_tokens=n_new) for p in prompts]
    done = engine.run()
    engine.pool.check_invariants()
    return [done[r].output_ids for r in rids]


@pytest.mark.gpu
def test_engine_prefix_cache_on_card_equals_dense(model):
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, VOCAB, 40).tolist()
    prompts = [prefix + rng.integers(0, VOCAB, n).tolist()
               for n in (8, 3, 11)]
    prompts.insert(1, list(prompts[0]))     # 48 tokens: three whole blocks
    engine = ServingEngine.from_model(model, block_size=16, max_slots=4,
                                      prefill_chunk=64)
    got = _serve(engine, prompts, 8)
    assert got == [_dense(model, p, 8) for p in prompts]
    snap = engine.metrics.snapshot()
    assert snap["prefix_hits"] > 0 and snap["cow_copies"] > 0


@pytest.mark.gpu
def test_engine_ngram_speculation_on_card_equals_dense(model):
    rng = np.random.default_rng(1)
    prompts = [(rng.integers(0, VOCAB, 8).tolist() * 4)[:28 + i]
               for i in range(4)]
    engine = ServingEngine.from_model(model, block_size=16, max_slots=4,
                                      prefill_chunk=64, spec="ngram")
    got = _serve(engine, prompts, 24)
    assert got == [_dense(model, p, 24) for p in prompts]
    assert engine.verify_dispatches > 0


@pytest.mark.gpu
def test_host_tier_bf16_round_trip_and_restore_fault_on_card():
    """A bf16 block spilled from the card's cached set to pinned host
    memory and restored into another block is byte-equal to the block
    spilled; a faulted restore leaves the pool and the tier intact, and
    the next restore succeeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = tflags.get_flags(["serving_prefix_cached_blocks", "fault_spec"])
    tflags.set_flags({"serving_prefix_cached_blocks": 1})
    try:
        pool = KVBlockPool(num_layers=4, num_blocks=8, block_size=16,
                           kv_heads=2, head_dim=128, dtype=torch.bfloat16,
                           prefix_cache=True, host_tier=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        pool._kv.copy_(torch.randn(pool._kv.shape, generator=gen,
                                   device="cuda"))
        tokens = list(range(40))
        pool.ensure(0, 33)
        pool.register_prefix_blocks(0, tokens, 33)
        deep = pool.table(0)[1]
        want = pool._kv[:, :, deep].clone()
        pool.free_seq(0)        # the deeper block leaves the cached set
        torch.cuda.synchronize()
        (key,) = pool.host_tier.keys()
        assert torch.equal(pool.host_tier._entries[key].block, want.cpu())
        pool._kv[:, :, pool._free] = 0
        tflags.set_flags({"fault_spec": "serving.host_tier.restore:times=1"})
        assert pool.acquire_prefix(1, tokens) == 16     # fell back cold
        assert pool.host_restore_failures == 1
        assert list(pool.host_tier.keys()) == [key]
        pool.check_invariants()
        pool.free_seq(1)
        assert pool.acquire_prefix(2, tokens) == 32     # restored
        restored = pool.table(2)[1]
        assert torch.equal(pool._kv[:, :, restored], want)
        assert pool.host_hits == 1 and len(pool.host_tier) == 0
        pool.free_seq(2)
        pool.check_invariants()
    finally:
        tflags.set_flags(old)
        fault.reset()
