"""The port's serving engine on the card, with the prefix cache and with
speculative decoding, against dense ``generate``.

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
