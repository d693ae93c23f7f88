"""GPT, BERT and DiT in the PyTorch port against the JAX package.

Each family is built tiny (two layers, narrow widths) in the JAX package,
its weights are carried into the port with ``load_reference_state``, and
both take the same numpy inputs on the CPU, where the port runs the plain
versions of its kernels. The JAX side takes its plain attention
(``use_flash_attention`` off) and its plain paged attention
(``serving_paged_kernel=reference``): its Pallas kernels are held against
the port in tests/test_torch_flash_attention.py and
tests/test_torch_kernels.py, and interpret mode is slow. DiT starts with
its adaLN-zero and final projections at zero, which would hide the
blocks from the loss, so every JAX parameter of every family is filled
with seeded noise before it is copied.

Checked, in f32: each family's forward, loss and every gradient; a
4-step ``TrainStep`` trajectory against ``paddle_tpu.jit.TrainStep``;
BERT with ``fused_head_loss`` on and off, with negative (ignored) labels
and token types; GPT's served greedy tokens against the JAX engine's and
GPT's ``quantize_for_decode`` (byte-equal int8, equal scales, a dense
head, greedy tokens equal); ``layer_norm`` in f32 and bf16; the tanh
GELU; and the zero-padded flash attention at head_dim 72 against the
unpadded plain version, forward and backward.
"""

import contextlib
import functools
import math
from unittest import mock

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import jax  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.framework.dtype import to_jax_dtype  # noqa: E402
from paddle_tpu.nn import initializer as jinit  # noqa: E402
from paddle_tpu.jit import TrainStep as JTrainStep  # noqa: E402
from paddle_tpu.jit.functional import (  # noqa: E402
    call_functional, get_buffers, get_params)
from paddle_tpu.serving import ServingEngine as JServingEngine  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu_torch import (TrainStep, load_reference_state,  # noqa: E402
                              quantize_for_decode)
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.nn import initializer as tinit  # noqa: E402
from paddle_tpu_torch.ops.hopper import flash_attention as hop_fa  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

# f32 on both sides, sums in other orders: logits, predictions and
# losses to ATOL + RTOL * |want|, every gradient to GRAD_ATOL
ATOL, RTOL = 2e-5, 1e-5
GRAD_ATOL = 1e-4
ENGINE = dict(block_size=4, max_slots=4, prefill_chunk=8)


@pytest.fixture(scope="module", autouse=True)
def _jax_plain_paths():
    """The JAX package's plain attention and plain paged attention, set
    for the module (module fixtures see it)."""
    keys = ("use_flash_attention", "serving_paged_kernel")
    before = pt.get_flags(list(keys))
    pt.set_flags({"use_flash_attention": False,
                  "serving_paged_kernel": "reference"})
    yield
    pt.set_flags(before)


def _arrays(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


@contextlib.contextmanager
def _zero_jax_init():
    """The JAX package draws each initial weight with a PRNG call that
    compiles once per shape (seconds for a tiny model). Every weight is
    overwritten with seeded noise here (``_noisy``), so while a JAX model
    is built its initialisers return zeros, made without a compile."""
    def zeros(self, shape, dtype="float32"):
        return jnp.asarray(np.zeros(tuple(shape),
                                    np.dtype(to_jax_dtype(dtype))))

    with contextlib.ExitStack() as stack:
        for cls in (jinit.Constant, jinit.Normal, jinit.Uniform):
            stack.enter_context(mock.patch.object(cls, "__call__", zeros))
        yield


def _jax_build(family, **cfg):
    """The family's tiny JAX model with every parameter noisy."""
    with _zero_jax_init():
        jm = FAMILIES[family][0](**cfg)
    return _noisy(jm, sorted(FAMILIES).index(family))


def _noisy(jm, seed):
    """Every parameter of the JAX model filled with seeded noise: weights
    0.1 * N(0, 1), LayerNorm weights 1 + 0.1 * N(0, 1)."""
    rng = np.random.RandomState(seed)
    for name, p in jm.named_parameters():
        noise = 0.1 * rng.randn(*p.shape).astype(np.float32)
        if name.rsplit(".", 1)[-1] == "weight" and len(p.shape) == 1:
            noise += 1.0
        p._data = jnp.asarray(noise)
    return jm


def _tokens(seed, b=2, s=16, vocab=128):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int64)
    labels = rng.randint(0, vocab, (b, s)).astype(np.int64)
    return rng, ids, labels


def _gpt_batch():
    _, ids, labels = _tokens(1)
    labels[0, :5] = -100
    return ids, labels


def _bert_batch():
    rng, ids, labels = _tokens(2)
    labels[:, ::3] = -1          # not masked: ignored
    labels[1, :4] = -7
    types = rng.randint(0, 2, ids.shape).astype(np.int64)
    return ids, labels, types


def _dit_batch():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 8, 8).astype(np.float32)
    t = rng.randint(0, 1000, (2,)).astype(np.int64)
    y = np.array([3, 10], np.int64)          # 10: the null class
    tgt = rng.randn(2, 4, 8, 8).astype(np.float32)
    return x, t, y, tgt


def _lm_out(call, ids, labels):
    return call(ids, labels=labels)


def _bert_out(call, ids, labels, types):
    return call(ids, labels=labels, token_type_ids=types)


def _dit_out(call, x, t, y, tgt):
    pred = call(x, t, y)
    return pred, ((pred - tgt) ** 2).mean()


def _bert_loss(model, ids, labels, types):
    _, loss = model(ids, labels=labels, token_type_ids=types)
    return loss


# name -> (JAX constructor, port constructor, batch, outputs of
# (call, *batch), JAX loss_fn, port loss_fn)
FAMILIES = {
    "gpt": (lambda **c: jmodels.GPTForCausalLM(jmodels.GPTConfig.tiny(**c)),
            lambda **c: tpt.GPTForCausalLM(tpt.GPTConfig.tiny(**c),
                                           device="cpu"),
            _gpt_batch, _lm_out, jmodels.llama.llama_loss_fn,
            tpt.llama_loss_fn),
    "bert": (lambda **c: jmodels.BertForPretraining(
        jmodels.BertConfig.tiny(**c)),
             lambda **c: tpt.BertForPretraining(tpt.BertConfig.tiny(**c),
                                                device="cpu"),
             _bert_batch, _bert_out, _bert_loss, _bert_loss),
    "bert_fused_head": (
        lambda **c: jmodels.BertForPretraining(
            jmodels.BertConfig.tiny(fused_head_loss=True, **c)),
        lambda **c: tpt.BertForPretraining(
            tpt.BertConfig.tiny(fused_head_loss=True, **c), device="cpu"),
        _bert_batch, _bert_out, _bert_loss, _bert_loss),
    "dit": (lambda **c: jmodels.DiT(jmodels.DiTConfig.tiny(**c)),
            lambda **c: tpt.DiT(tpt.DiTConfig.tiny(**c), device="cpu"),
            _dit_batch, _dit_out, jmodels.dit_loss_fn, tpt.dit_loss_fn),
}


@functools.lru_cache(maxsize=None)
def _jax_model_state(family):
    """The family's tiny JAX model with every parameter noisy, and its
    state as numpy arrays."""
    jm = _jax_build(family)
    return jm, _arrays(jm)


def _port_model(family, jm=None, **cfg):
    """The port's copy of ``jm`` (the family's shared JAX model)."""
    tm = FAMILIES[family][1](**cfg)
    load_reference_state(tm, _arrays(jm) if jm is not None
                         else _jax_model_state(family)[1])
    return tm


@functools.lru_cache(maxsize=None)
def _jax_reference(family):
    """The JAX model's outputs (logits or prediction), loss and every
    gradient on the family's batch, from one jitted function."""
    jm, _ = _jax_model_state(family)
    outputs = FAMILIES[family][3]
    buffers = get_buffers(jm)

    def run(params, *args):
        def f(p):
            def call(*a, **k):
                out, _ = call_functional(
                    jm, p, buffers, tuple(map(pt.to_tensor, a)),
                    {n: pt.to_tensor(v) for n, v in k.items()})
                return out
            out, loss = outputs(call, *args)
            return loss, out
        return jax.value_and_grad(f, has_aux=True)(params)

    (loss, out), grads = jax.jit(run)(
        get_params(jm), *(jnp.asarray(a) for a in FAMILIES[family][2]()))
    return loss, out, grads


@functools.lru_cache(maxsize=None)
def _port_run(family):
    """The port's outputs, loss and gradients on the same weights and
    batch."""
    tm = _port_model(family)
    out, loss = FAMILIES[family][3](tm, *(torch.from_numpy(a)
                                          for a in FAMILIES[family][2]()))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    return (None if out is None else out.detach().numpy(),
            loss.detach().numpy(), grads)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_matches_jax(family):
    """GPT's and BERT's logits (none with the fused head), DiT's
    prediction."""
    _, jout, _ = _jax_reference(family)
    tout, _, _ = _port_run(family)
    if family == "bert_fused_head":
        assert tout is None and jout is None
        return
    assert tout.shape == np.asarray(jout).shape
    np.testing.assert_allclose(tout, np.asarray(jout), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_matches_jax(family):
    jloss, _, _ = _jax_reference(family)
    _, tloss, _ = _port_run(family)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_gradient_matches_jax(family):
    """Every parameter's gradient, by name: the same names on both
    sides."""
    _, _, jgrads = _jax_reference(family)
    _, _, tgrads = _port_run(family)
    assert set(tgrads) == set(jgrads)
    for n, g in tgrads.items():
        np.testing.assert_allclose(g, np.asarray(jgrads[n]), atol=GRAD_ATOL,
                                   rtol=0, err_msg=n)


# Adam divides each update by sqrt(v) + epsilon: at the default 1e-8 an
# element whose gradient is near zero moves by up to a learning rate on
# the rounding of that gradient, which the two frameworks do not share.
EPS = 1e-4


@pytest.mark.parametrize("family", ["gpt", "bert_fused_head", "dit"])
def test_trainstep_trajectory_matches_jax(family):
    """4 AdamW steps (f32, weight decay): the losses to ATOL + RTOL and
    the final weights to GRAD_ATOL against the JAX TrainStep. One layer:
    the JAX step compiles twice, and its compile time grows with depth;
    the gradients' parity through two layers is held above."""
    depth = {"dit": dict(depth=1)}.get(family, dict(num_hidden_layers=1))
    jm = _jax_build(family, **depth)
    tm = _port_model(family, jm, **depth)
    kw = dict(learning_rate=1e-3, epsilon=EPS, weight_decay=0.01)
    jstep = JTrainStep(jm, jopt.AdamW(parameters=jm.parameters(), **kw),
                       FAMILIES[family][4])
    tstep = TrainStep(tm, AdamW(**kw), FAMILIES[family][5])
    batch = FAMILIES[family][2]()
    jl = [float(jstep(*map(pt.to_tensor, batch))) for _ in range(4)]
    tl = [float(tstep(*map(torch.from_numpy, batch))) for _ in range(4)]
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=RTOL)
    assert tl[-1] < tl[0]
    want = _arrays(jm)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n],
                                   atol=GRAD_ATOL, rtol=0, err_msg=n)


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 128, (n,)).tolist() for n in lengths]


@pytest.fixture(scope="module")
def gpt_pair():
    """A tiny JAX GPT in eval mode and the port's copy of it."""
    jm, state = _jax_model_state("gpt")
    jm.eval()
    tm = _port_model("gpt")
    tm.eval()
    return jm, tm


def test_gpt_engine_greedy_matches_jax_engine(gpt_pair):
    """The serving engines over GPT (geometry from ``model.gpt.cfg``,
    K/V at every head, per-row positions into ``wpe``, chunked prompts):
    the same tokens for every request."""
    jm, tm = gpt_pair
    prompts = _prompts(6, (5, 11, 9, 19))
    jeng = JServingEngine.from_model(jm, prefix_cache=False, **ENGINE)
    teng = tpt.ServingEngine.from_model(tm, device="cpu", prefix_cache=False,
                                        **ENGINE)
    assert (teng.num_layers, teng.kv_heads, teng.head_dim,
            teng.max_context) == (2, 4, 16, 64)
    jids = [jeng.add_request(p, max_new_tokens=6) for p in prompts]
    tids = [teng.add_request(p, max_new_tokens=6) for p in prompts]
    jdone, tdone = jeng.run(), teng.run()
    for j, t in zip(jids, tids):
        assert tdone[t].output_ids == jdone[j].output_ids
    teng.pool.check_invariants()


def test_gpt_generate_greedy_matches_jax(gpt_pair):
    """Dense-cache greedy ``generate``: the same tokens."""
    jm, tm = gpt_pair
    ids = np.asarray(_prompts(5, [7, 7]), np.int32)
    want = jm.generate(pt.to_tensor(ids), max_new_tokens=6).numpy()
    got = tm.generate(torch.from_numpy(ids).long(), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def gpt_quantized():
    """A second tiny GPT pair, each quantized by its own package."""
    jm = _jax_build("gpt")
    jm.eval()
    tm = _port_model("gpt", jm)
    jmodels.quantize_for_decode(jm)
    quantize_for_decode(tm)
    return jm, tm


def test_gpt_quantize_gives_the_jax_bytes_and_a_dense_head(gpt_quantized):
    """The qkv, out and MLP linears (4 a layer) are int8, byte-equal to
    the JAX package's, with equal scales; ``lm_head`` stays dense."""
    jm, tm = gpt_quantized
    want = _arrays(jm)
    got = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    int8 = sorted(k for k, v in got.items() if v.dtype == np.int8)
    assert len(int8) == 2 * 4
    assert all(k.endswith(("qkv_proj.weight", "out_proj.weight",
                           "fc_in.weight", "fc_out.weight")) for k in int8)
    assert tm.lm_head.dtype == torch.float32 and not tm.training


def test_gpt_quantized_greedy_matches_jax(gpt_quantized):
    """Greedy ``generate`` and the engine over the quantized GPTs: the
    JAX package's tokens."""
    jm, tm = gpt_quantized
    ids = np.asarray(_prompts(8, [9, 9]), np.int32)
    want = jm.generate(pt.to_tensor(ids), max_new_tokens=6).numpy()
    got = tm.generate(torch.from_numpy(ids).long(), max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), want)
    teng = tpt.ServingEngine.from_model(tm, device="cpu", prefix_cache=False,
                                        **ENGINE)
    rids = [teng.add_request(p, max_new_tokens=6) for p in ids.tolist()]
    done = teng.run()
    assert [done[r].output_ids for r in rids] == want[:, 9:].tolist()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
def test_layer_norm_matches_jax(dtype, affine):
    """``layer_norm`` over the last axis (and ``LayerNorm``), f32 to ATOL
    + RTOL; bf16 (statistics in f32, one rounding each side) to one bf16
    ulp of the largest value."""
    from paddle_tpu.nn import functional as JF

    rng = np.random.RandomState(9)
    x = (3.0 * rng.randn(3, 5, 48) + 1.5).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(48)).astype(np.float32) if affine else None
    b = (0.1 * rng.randn(48)).astype(np.float32) if affine else None
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)

    def jt(a):
        return None if a is None else pt.to_tensor(jnp.asarray(a, jdt))

    def tt(a):
        return None if a is None else torch.from_numpy(a).to(tdt)

    want = np.asarray(JF.layer_norm(jt(x), 48, jt(w), jt(b), 1e-5)._data
                      .astype(jnp.float32))
    got = TF.layer_norm(tt(x), 48, tt(w), tt(b), 1e-5)
    assert got.dtype == tdt
    tol = (dict(atol=ATOL, rtol=RTOL) if dtype == "float32" else
           dict(atol=2.0 ** -8 * float(np.abs(want).max()), rtol=0))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    layer = tpt.nn.LayerNorm(48, epsilon=1e-5, device="cpu", dtype=tdt,
                             weight_attr=None if affine else False,
                             bias_attr=None if affine else False)
    if affine:
        with torch.no_grad():
            layer.weight.copy_(tt(w))
            layer.bias.copy_(tt(b))
    assert torch.equal(layer(tt(x)), got)


@pytest.mark.parametrize("approximate", [True, False],
                         ids=["tanh", "erf"])
def test_gelu_matches_jax(approximate):
    """The models' GELU is ``jax.nn.gelu``'s default, the tanh form
    (``F.gelu(x, approximate=True)``); ``F.gelu``'s own default is the
    erf form, as the JAX package's ``F.gelu``. Values and gradients."""
    x = np.linspace(-6, 6, 97).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=approximate))
    dwant = np.asarray(jax.grad(lambda v: jax.nn.gelu(
        v, approximate=approximate).sum())(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = TF.gelu(xt, approximate=approximate)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), dwant, atol=ATOL, rtol=RTOL)
    if not approximate:
        torch.testing.assert_close(TF.gelu(xt.detach()), got.detach())
    np.testing.assert_allclose(
        TF.silu(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.silu(jnp.asarray(x))), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True],
                         ids=["noncausal", "causal"])
def test_head_dim_72_padded_matches_unpadded(causal):
    """The d = 72 route of the kernels' wrappers, on the plain versions:
    q, k, v, out and dout zero-padded to 128, the caller's scale
    1/sqrt(72), then out, dq, dk and dv sliced back, equal the unpadded
    plain forward and backward at d = 72 (f32, 1e-5: zero columns add
    nothing but the order of the sums)."""
    rng = np.random.RandomState(12)
    b, s, h, kv, d = 2, 40, 4, 2, 72
    q, k, v, dout = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                     for shape in ((b, s, h, d), (b, s, kv, d),
                                   (b, s, kv, d), (b, s, h, d)))
    scale = 1.0 / math.sqrt(d)
    assert hop_fa.padded_head_dim(d) == 128
    out, lse = hop_fa.flash_attention_fwd_padded(q, k, v, causal, scale)
    want_out, want_lse = hop_fa.flash_attention_fwd_reference(
        q, k, v, causal, scale)
    assert out.shape == want_out.shape
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    got = hop_fa.flash_attention_bwd_padded(q, k, v, out, lse, dout, causal,
                                            scale)
    want = hop_fa.flash_attention_bwd_reference(q, k, v, want_out, want_lse,
                                                dout, causal, scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    padded = hop_fa.pad_head_dim(q, 128)
    assert torch.equal(padded[..., :d], q) and not padded[..., d:].any()


def test_initializers_draw_from_the_callers_generator():
    """``Normal``, ``Constant`` and ``XavierUniform`` fill in place from
    the generator given: the same seed draws the same values; Xavier's
    limit uses Paddle's fans of an ``[in, out]`` weight."""
    def draw(init, seed, shape=(300, 200)):
        p = torch.nn.Parameter(torch.empty(shape))
        init(p, torch.Generator().manual_seed(seed))
        return p.detach()

    a, b = draw(tinit.Normal(std=0.02), 1), draw(tinit.Normal(std=0.02), 1)
    assert torch.equal(a, b)
    assert not torch.equal(a, draw(tinit.Normal(std=0.02), 2))
    assert abs(float(a.std()) - 0.02) < 1e-3 and abs(float(a.mean())) < 1e-3
    x = draw(tinit.XavierUniform(), 3)
    limit = math.sqrt(6.0 / (300 + 200))
    top = float(x.abs().max())
    assert 0.99 * limit < top <= limit
    assert not draw(tinit.Constant(0.0), 0).any()
    bf = torch.nn.Parameter(torch.empty(4, 4, dtype=torch.bfloat16))
    tinit.Normal(std=0.02)(bf, torch.Generator().manual_seed(1))
    assert bf.dtype == torch.bfloat16


def test_entry_points_raise_without_a_card(monkeypatch):
    """No device argument means the card: with none present the models
    raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for model, cfg in ((tpt.GPTForCausalLM, tpt.GPTConfig.tiny()),
                       (tpt.BertForPretraining, tpt.BertConfig.tiny()),
                       (tpt.DiT, tpt.DiTConfig.tiny())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model(cfg)
        assert next(model(cfg, device="cpu").parameters()).device.type \
            == "cpu"
