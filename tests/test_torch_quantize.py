"""Weight-only int8 serving in the PyTorch port against the JAX package.

A tiny two-layer Llama is built in the JAX package and copied into the
port; both are quantized with their own ``quantize_for_decode``:

- the int8 weights are byte-equal and the scales equal (15 of each:
  7 linears a layer and the untied head), and the port's weights are
  frozen parameters of a model in eval mode;
- the port's plain ``int8_matmul_plain`` equals the JAX package's
  ``_int8_matmul`` on seeded numpy inputs (f32, 1e-5);
- greedy ``generate`` and the serving engine give the JAX package's
  tokens, token for token (the JAX engine runs its plain paged
  attention, set by a module fixture);
- a quantized JAX state loads into a quantized port model through
  ``load_reference_state``; a float state into a quantized model, and a
  quantized state into a float model, raise.

Everything runs on the CPU, where the port takes the plain version of
kernel K10; the kernel itself is held against the plain version on the
card (tests/test_torch_kernels.py, ``gpu``).
"""

import types

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import paddle_tpu as pt  # noqa: E402
from paddle_tpu.distributed.fleet.mpu import \
    _int8_matmul as jint8_matmul  # noqa: E402
from paddle_tpu.models import LlamaConfig as JLlamaConfig  # noqa: E402
from paddle_tpu.models import \
    LlamaForCausalLM as JLlamaForCausalLM  # noqa: E402
from paddle_tpu.models import \
    quantize_for_decode as jquantize_for_decode  # noqa: E402
from paddle_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
from paddle_tpu_torch import (LlamaConfig, LlamaForCausalLM,  # noqa: E402
                              ServingEngine, load_reference_state,
                              quantize_for_decode)
from paddle_tpu_torch.ops.hopper.int8_matmul import (  # noqa: E402
    int8_matmul, int8_matmul_cuda, int8_matmul_plain, int8_matmul_plan)
from torch_threads import one_torch_thread  # noqa: E402, F401

GEOM = dict(num_hidden_layers=2, num_key_value_heads=2,
            max_position_embeddings=96)
ENGINE = dict(block_size=4, max_slots=4, prefill_chunk=8)


@pytest.fixture(scope="module", autouse=True)
def _jax_plain_attention():
    """The JAX engine runs its plain paged attention (interpret-mode
    Pallas is slow); module-scoped, so the module fixtures see it."""
    before = pt.get_flags("serving_paged_kernel")["serving_paged_kernel"]
    pt.set_flags({"serving_paged_kernel": "reference"})
    yield
    pt.set_flags({"serving_paged_kernel": before})


def _arrays(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


@pytest.fixture(scope="module")
def float_state():
    pt.seed(17)
    jm = JLlamaForCausalLM(JLlamaConfig.tiny(**GEOM))
    jm.eval()
    return jm, _arrays(jm)


@pytest.fixture(scope="module")
def quantized(float_state):
    """(JAX model, port model), each quantized by its own package."""
    jm, arrays = float_state
    tm = LlamaForCausalLM(LlamaConfig.tiny(**GEOM), device="cpu")
    load_reference_state(tm, arrays)
    jquantize_for_decode(jm)
    quantize_for_decode(tm)
    return jm, tm


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)).tolist() for n in lengths]


def test_quantize_gives_the_jax_bytes_and_scales(quantized):
    """Byte-equal int8 weights and equal f32 scales, for all 2 x 7 + 1
    quantized weights; the rest of the state is untouched; the port's
    int8 weights are frozen parameters and the model is in eval mode."""
    jm, tm = quantized
    want = _arrays(jm)
    got = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert set(got) == set(want) - {k for k in want
                                    if k.endswith((".rope_cos",
                                                   ".rope_sin"))}
    int8 = [k for k, v in got.items() if v.dtype == np.int8]
    assert len(int8) == 2 * 7 + 1
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    for k in int8:
        scale = got[k.replace(".weight", ".weight_scale")]
        assert scale.dtype == np.float32
        assert scale.shape == (1, got[k].shape[1])
    params = dict(tm.named_parameters())
    assert all(not params[k].requires_grad for k in int8)
    assert not tm.training


def test_quantize_memory_skips_and_idempotence():
    """Linear weight bytes fall to a quarter of f32's; a tied head stays
    dense (it aliases the embedding); quantizing again changes nothing."""
    from paddle_tpu_torch.distributed.fleet.mpu import ColumnParallelLinear

    tm = LlamaForCausalLM(LlamaConfig.tiny(tie_word_embeddings=True, **GEOM),
                          device="cpu", seed=2)

    def linear_bytes():
        return sum(m.weight.numel() * m.weight.element_size()
                   for m in tm.modules()
                   if isinstance(m, ColumnParallelLinear))

    before = linear_bytes()
    quantize_for_decode(tm)
    assert 4 * linear_bytes() == before
    assert tm.lm_head._tied and not hasattr(tm.lm_head, "weight_scale")
    assert tm.llama.embed_tokens.weight.dtype == torch.float32
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    quantize_for_decode(tm)
    for k, v in tm.state_dict().items():
        assert torch.equal(v, state[k]), k


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 16)],
                         ids=["rows", "batched"])
def test_int8_matmul_plain_matches_jax(shape):
    """``(x @ q) * s`` in f32: the plain version against the JAX
    package's ``_int8_matmul`` to 1e-5 (one product, other orders)."""
    rng = np.random.RandomState(3)
    x = rng.randn(*shape).astype(np.float32)
    q = rng.randint(-127, 128, (16, 32)).astype(np.int8)
    s = (rng.rand(1, 32).astype(np.float32) + 0.5) / 127
    layer = types.SimpleNamespace(weight_scale=pt.to_tensor(s))
    want = np.asarray(jint8_matmul(layer, jnp.asarray(x), jnp.asarray(q)))
    got = int8_matmul_plain(torch.from_numpy(x), torch.from_numpy(q),
                            torch.from_numpy(s))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(int8_matmul(torch.from_numpy(x),
                                           torch.from_numpy(q),
                                           torch.from_numpy(s)), got,
                               atol=0, rtol=0)


@pytest.mark.parametrize("case", ["x_float16", "q_float", "q_strided",
                                  "n_not_16", "k_mismatch", "cpu_tensor"])
def test_int8_matmul_kernel_refuses_what_it_does_not_take(case):
    """The kernel's wrapper raises on a dtype, layout or shape it does not
    take, and on a tensor that is not on a card: it never falls back."""
    x = torch.zeros(2, 32)
    q = torch.zeros(32, 48, dtype=torch.int8)
    s = torch.ones(1, 48)
    if case == "x_float16":
        x = x.half()
    elif case == "q_float":
        q = q.float()
    elif case == "q_strided":
        q = torch.zeros(48, 32, dtype=torch.int8).t()
        s = torch.ones(1, 32)
    elif case == "n_not_16":
        q, s = torch.zeros(32, 40, dtype=torch.int8), torch.ones(1, 40)
    elif case == "k_mismatch":
        x = torch.zeros(2, 24)
    with pytest.raises(ValueError):
        int8_matmul_cuda(x, q, s)


@pytest.mark.parametrize("m,n,k,dtype,want", [
    # decode: the output tiles fill a quarter of the card, K splits 8 ways
    (1, 4096, 4096, torch.bfloat16, dict(mi=1, splits=8, per=8)),
    (8, 11008, 4096, torch.bfloat16, dict(mi=1, splits=4, per=16)),
    (8, 4096, 11008, torch.bfloat16, dict(mi=1, splits=9, per=20)),
    # a prefill chunk of 512 rows fills the card without a split
    (512, 4096, 4096, torch.bfloat16, dict(mi=4, splits=1, per=64)),
    (1, 4096, 4096, torch.float32, dict(mi=1, splits=5, per=52)),
    (512, 4096, 4096, torch.float32, dict(mi=1, splits=1, per=256)),
])
def test_int8_matmul_plan(m, n, k, dtype, want):
    """The launch plan: the row tiles and the split of K, every split
    non-empty and together covering K once."""
    plan = int8_matmul_plan(m, n, k, dtype)
    assert {key: plan[key] for key in want} == want
    stages = -(-k // plan["bk"])
    assert (plan["splits"] - 1) * plan["per"] < stages \
        <= plan["splits"] * plan["per"]


def test_generate_greedy_matches_jax(quantized):
    """Greedy decoding of the quantized models: the same tokens."""
    jm, tm = quantized
    ids = np.asarray(_prompts(5, [7, 7]), np.int32)
    want = jm.generate(pt.to_tensor(ids), max_new_tokens=6).numpy()
    got = tm.generate(torch.from_numpy(ids).long(), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_greedy_matches_jax_engine(quantized):
    """The serving engines over the quantized models (ragged prefill and
    decode, chunked prompts): the same tokens for every request."""
    jm, tm = quantized
    prompts = _prompts(6, (5, 11, 9))
    jeng = JServingEngine.from_model(jm, prefix_cache=False, **ENGINE)
    teng = ServingEngine.from_model(tm, device="cpu", prefix_cache=False,
                                    **ENGINE)
    jids = [jeng.add_request(p, max_new_tokens=6) for p in prompts]
    tids = [teng.add_request(p, max_new_tokens=6) for p in prompts]
    jdone, tdone = jeng.run(), teng.run()
    for j, t in zip(jids, tids):
        assert tdone[t].output_ids == jdone[j].output_ids
    teng.pool.check_invariants()


def test_load_quantized_state_and_mismatches(float_state, quantized):
    """A quantized JAX state loads into a quantized port model (int8
    stays int8, ``weight_scale`` is a persistent buffer); a float state
    into a quantized model, or the reverse, raises naming both sides."""
    jm, _ = quantized
    qstate = _arrays(jm)
    tm = quantize_for_decode(LlamaForCausalLM(LlamaConfig.tiny(**GEOM),
                                              device="cpu", seed=5))
    load_reference_state(tm, qstate)
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), qstate[k], err_msg=k)
    assert tm.llama.layers[0].mlp.up_proj.weight.dtype == torch.int8
    with pytest.raises(ValueError, match="state is float.*model is "
                                         "quantized"):
        load_reference_state(tm, float_state[1])
    dense = LlamaForCausalLM(LlamaConfig.tiny(**GEOM), device="cpu")
    with pytest.raises(ValueError, match="state is quantized.*model is "
                                         "float"):
        load_reference_state(dense, qstate)
