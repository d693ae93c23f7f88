"""Llama training in the PyTorch port against the JAX package.

A tiny Llama is built in the JAX package, its weights are carried into
the port with ``load_reference_state``, and both take the same numpy
batches on the CPU, where the port runs the plain versions of its
kernels (flash attention with its FA2 backward, RMSNorm with its
gradient). The JAX side takes its plain attention
(``use_flash_attention`` off): its Pallas flash kernels are held against
the port in tests/test_torch_flash_attention.py, and interpret mode is
slow. Checked: the cache-less logits, the loss (plain and fused LM head)
and every parameter's gradient; and 4-step ``TrainStep`` trajectories
with AdamW, decay exclusion, global-norm clipping and bf16
multi-precision.
"""

import functools

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import jax  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.jit import TrainStep as JTrainStep  # noqa: E402
from paddle_tpu.jit.functional import (  # noqa: E402
    call_functional, get_buffers, get_params)
from paddle_tpu.models import LlamaConfig as JLlamaConfig  # noqa: E402
from paddle_tpu.models import (  # noqa: E402
    LlamaForCausalLM as JLlamaForCausalLM)
from paddle_tpu.models import llama_loss_fn as jllama_loss_fn  # noqa: E402
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip  # noqa: E402
from paddle_tpu_torch import (LlamaConfig, LlamaForCausalLM,  # noqa: E402
                              TrainStep, llama_loss_fn, load_reference_state)
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm  # noqa: E402
from paddle_tpu_torch.optimizer import Adam, AdamW  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

GEOM = dict(max_position_embeddings=256)


@pytest.fixture(scope="module", autouse=True)
def _jax_plain_attention():
    before = pt.get_flags("use_flash_attention")["use_flash_attention"]
    pt.set_flags({"use_flash_attention": False})
    yield
    pt.set_flags({"use_flash_attention": before})


def _jax_model(**extra):
    pt.seed(11)
    return JLlamaForCausalLM(JLlamaConfig.tiny(**GEOM, **extra))


def _state(jm):
    """The JAX state dict as f32 numpy arrays (bf16 widens exactly)."""
    return {k: np.asarray(v._data.astype(jnp.float32))
            for k, v in jm.state_dict().items()}


def _port_model(jm, **extra):
    tm = LlamaForCausalLM(LlamaConfig.tiny(**GEOM, **extra), device="cpu")
    load_reference_state(tm, _state(jm))
    return tm


def _batch(seed, s, b=2):
    """Token ids and labels; a few labels are ignored (-100)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, (b, s)).astype(np.int64)
    labels = rng.randint(0, 128, (b, s)).astype(np.int64)
    labels[0, :7] = -100
    return ids, labels


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(s):
    """The JAX model's logits, loss and gradients at sequence length
    ``s``, with the plain and the fused head: one jitted function for
    both (the model reads ``fused_head_loss`` when it is called)."""
    jm = _jax_model()
    ids, labels = _batch(s, s)
    buffers = get_buffers(jm)

    def loss_of(params, i, lab, fused):
        jm.config.fused_head_loss = fused
        (logits, loss), _ = call_functional(
            jm, params, buffers, (pt.to_tensor(i),),
            {"labels": pt.to_tensor(lab)})
        return loss, logits

    def both(params, i, lab):
        return [jax.value_and_grad(loss_of, has_aux=True)(params, i, lab, f)
                for f in (False, True)]

    out = jax.jit(both)(get_params(jm), jnp.asarray(ids), jnp.asarray(labels))
    return _state(jm), ids, labels, out


@pytest.mark.parametrize("fused", [False, True], ids=["plain_head",
                                                      "fused_head"])
@pytest.mark.parametrize("s", [128, 256])
def test_cacheless_logits_loss_and_grads_match_jax(s, fused):
    """f32: logits and loss to 1e-5, every parameter's gradient to 1e-5
    absolute (both sides sum in other orders; gradients are O(1e-2))."""
    state, ids, labels, out = _jax_loss_and_grads(s)
    (jloss, jlogits), jgrads = out[int(fused)]
    tm = LlamaForCausalLM(LlamaConfig.tiny(**GEOM, fused_head_loss=fused),
                          device="cpu")
    load_reference_state(tm, state)
    logits, loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    loss = loss.detach()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    if fused:
        assert logits is None and jlogits is None
    else:
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(jlogits), atol=1e-5, rtol=1e-5)
    grads = dict(tm.named_parameters())
    assert set(grads) == set(jgrads)
    for n, p in grads.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[n]),
                                   atol=1e-5, rtol=1e-4, err_msg=n)


TRAIN_CASES = {
    # f32, weight decay with the norms exempt
    "f32_decay": dict(bf16=False, clip=None),
    # ... and a global-norm clip that binds (grad norms are ~1-2)
    "f32_decay_clip": dict(bf16=False, clip=0.5),
    # bf16 parameters with f32 masters
    "bf16_multi_precision_clip": dict(bf16=True, clip=0.5),
}


# Adam divides each update by sqrt(v) + epsilon: at the default 1e-8 an
# element whose gradient is near zero moves by up to a learning rate on
# the rounding of that gradient, which the two frameworks do not share.
# 1e-4 damps those elements and leaves every other update as it is.
EPS = 1e-4


def _decay(name):
    # picks the same parameters under both naming schemes: the port's
    # "llama.layers.0.input_layernorm.weight", the JAX package's
    # "llamarmsnorm_0.w_0"
    return "norm" not in name


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_trainstep_trajectory_matches_jax(case):
    """4 AdamW steps: losses and final weights against
    ``paddle_tpu.jit.TrainStep``. f32: losses to 1e-5, weights to 1e-5
    absolute (other summation orders). bf16: the forward rounds at other
    places in the two frameworks: losses to 1e-3, and the f32 masters to
    1e-3 absolute, a quarter of the largest move that 4 steps at a
    learning rate of 1e-3 make (~4e-3)."""
    bf16, clip = TRAIN_CASES[case]["bf16"], TRAIN_CASES[case]["clip"]
    lr = 1e-3 if bf16 else 1e-2
    # one decoder layer: the JAX step's compile time grows with depth,
    # and the gradients' parity through two layers is checked above
    jm = _jax_model(num_hidden_layers=1)
    if bf16:
        for _, p in jm.named_parameters():
            p._data = p._data.astype(jnp.bfloat16)
    tm = _port_model(jm, num_hidden_layers=1,
                     dtype="bfloat16" if bf16 else "float32")
    jstep = JTrainStep(jm, jopt.AdamW(
        learning_rate=lr, epsilon=EPS, parameters=jm.parameters(),
        weight_decay=0.1, apply_decay_param_fun=_decay, multi_precision=True,
        grad_clip=None if clip is None else JClip(clip)), jllama_loss_fn)
    tstep = TrainStep(tm, AdamW(
        learning_rate=lr, epsilon=EPS, weight_decay=0.1,
        apply_decay_param_fun=_decay, multi_precision=True,
        grad_clip=None if clip is None else ClipGradByGlobalNorm(clip)),
        llama_loss_fn)
    ids, labels = _batch(100, 64)
    jl = [float(jstep(pt.to_tensor(ids), pt.to_tensor(labels)))
          for _ in range(4)]
    tl = [float(tstep(torch.from_numpy(ids), torch.from_numpy(labels)))
          for _ in range(4)]
    np.testing.assert_allclose(tl, jl, rtol=1e-3 if bf16 else 1e-5)
    assert tl[-1] < tl[0]
    if bf16:
        want = {n: np.asarray(a) for n, a in jstep._state["master"].items()}
        got = {n: m.numpy() for n, m in tstep._master.items()}
        assert len(got) == len(dict(tm.named_parameters()))
    else:
        want = _state(jm)
        got = {n: p.detach().numpy() for n, p in tm.named_parameters()}
    for n, g in got.items():
        np.testing.assert_allclose(g, want[n], atol=1e-3 if bf16 else 1e-5,
                                   rtol=0, err_msg=n)


@pytest.mark.parametrize("name", ["Adam", "AdamW"])
def test_optimizer_update_matches_jax(name):
    """Three updates of one f32 weight with decay (L2 into the gradient
    for Adam, decoupled for AdamW): the port's in-place ``_update``
    equals the JAX package's pure one to 1e-6."""
    rng = np.random.RandomState(4)
    w = rng.randn(8, 16).astype(np.float32)
    grads = [rng.randn(8, 16).astype(np.float32) for _ in range(3)]
    kw = dict(learning_rate=1e-2, weight_decay=0.1)
    jo = getattr(jopt, name)(parameters=[], **kw)
    to = {"Adam": Adam, "AdamW": AdamW}[name](**kw)
    jw, tw = jnp.asarray(w), torch.from_numpy(w.copy())
    js, ts = jo._init_slots(jw), to._init_slots(tw)
    for step, g in enumerate(grads, 1):
        jw, js = jo._update(jw, jnp.asarray(g), js, 1e-2, step)
        to._update(tw, torch.from_numpy(g), ts, 1e-2, step)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   atol=1e-6, rtol=1e-6)


OPTIMIZER_CASES = {
    # Adam's default: no weight decay
    "Adam_no_decay": ("Adam", {}, None),
    "Adam_betas_epsilon": ("Adam", dict(beta1=0.8, beta2=0.99,
                                        epsilon=1e-6), None),
    # a per-parameter coefficient passed to _update overrides the
    # optimizer's, as TrainStep passes _param_wd(name)
    "Adam_param_wd_override": ("Adam", dict(weight_decay=0.1), 0.05),
    "AdamW_zero_decay": ("AdamW", dict(weight_decay=0.0), None),
    "AdamW_exempt_param": ("AdamW", dict(weight_decay=0.1), 0.0),
    "AdamW_strong_decay_beta1": ("AdamW", dict(weight_decay=0.3, beta1=0.5),
                                 None),
}


@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_optimizer_update_options_match_jax(case):
    """Three f32 updates under each option the port takes equal the JAX
    package's ``_update`` to 1e-6 (one rounding order apart)."""
    name, kw, wd = OPTIMIZER_CASES[case]
    rng = np.random.RandomState(6)
    w = rng.randn(8, 16).astype(np.float32)
    grads = [rng.randn(8, 16).astype(np.float32) for _ in range(3)]
    kw = dict(learning_rate=1e-2, **kw)
    jo = getattr(jopt, name)(parameters=[], **kw)
    to = {"Adam": Adam, "AdamW": AdamW}[name](**kw)
    jw, tw = jnp.asarray(w), torch.from_numpy(w.copy())
    js, ts = jo._init_slots(jw), to._init_slots(tw)
    for step, g in enumerate(grads, 1):
        jw, js = jo._update(jw, jnp.asarray(g), js, 1e-2, step, wd)
        to._update(tw, torch.from_numpy(g), ts, 1e-2, step, wd)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name,want", [
    ("llama.layers.0.input_layernorm.weight", 0.0),
    ("llama.norm.weight", 0.0),
    ("llama.layers.0.self_attn.q_proj.weight", 0.1),
    ("lm_head.weight", 0.1),
])
def test_adamw_apply_decay_param_fun_on_structured_names(name, want):
    """AdamW exempts a parameter whose structured name
    ``apply_decay_param_fun`` refuses, and decays the rest at its
    coefficient; Adam has no exemption."""
    opt = AdamW(weight_decay=0.1, apply_decay_param_fun=_decay)
    assert opt._param_wd(name) == want
    assert Adam(weight_decay=0.1)._param_wd(name) == 0.1


@pytest.mark.parametrize("make", [
    lambda: AdamW(learning_rate=object()),
    lambda: AdamW(lr_ratio=lambda p: 1.0),
], ids=["lr_scheduler", "lr_ratio"])
def test_optimizer_options_not_ported_raise(make):
    with pytest.raises(NotImplementedError):
        make()


@pytest.mark.parametrize("norm", [0.5, 1e3, float("nan")],
                         ids=["binding", "loose", "nan_poisons"])
def test_clip_by_global_norm_matches_jax(norm):
    """ClipGradByGlobalNorm scales every gradient by
    clip_norm / max(global norm, clip_norm), as the JAX package's does;
    a NaN gradient poisons every gradient instead of being hidden."""
    rng = np.random.RandomState(5)
    gs = [rng.randn(4, 3).astype(np.float32), rng.randn(7).astype(np.float32)]
    if norm != norm:
        gs[1][2] = np.nan
    clip = 0.5 if norm != norm else norm
    want = JClip(clip)([(None, pt.to_tensor(g)) for g in gs])
    got = ClipGradByGlobalNorm(clip)([(None, torch.from_numpy(g))
                                      for g in gs] + [(None, None)])
    assert got[-1] == (None, None)
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w.numpy()),
                                   rtol=1e-6, atol=1e-7, equal_nan=True)
    if norm != norm:
        assert all(np.isnan(g.numpy()).all() for _, g in got[:-1])


@pytest.mark.parametrize("case", ["zero_grads", "bf16_grad", "only_none"])
def test_clip_by_global_norm_edge_cases_match_jax(case):
    """All-zero gradients stay zero (no 0/0); a bf16 gradient is scaled
    in f32 and cast back to bf16, as in the JAX package; a list of only
    ``None`` gradients passes through."""
    rng = np.random.RandomState(7)
    if case == "only_none":
        assert ClipGradByGlobalNorm(0.5)([(None, None)]) == [(None, None)]
        return
    gs = [rng.randn(4, 3).astype(np.float32) * 3,
          rng.randn(7).astype(np.float32)]
    if case == "zero_grads":
        gs = [np.zeros_like(g) for g in gs]
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if case == "bf16_grad"
                else (jnp.float32, torch.float32))
    want = JClip(0.5)([(None, pt.to_tensor(jnp.asarray(g, jdt)))
                       for g in gs])
    got = ClipGradByGlobalNorm(0.5)([(None, torch.from_numpy(g).to(tdt))
                                     for g in gs])
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == tdt
        np.testing.assert_array_equal(
            g.float().numpy(), np.asarray(w._data.astype(jnp.float32)))


CE_CASES = ["all_valid", "some_ignored", "ignore_index_0",
            "label_trailing_1", "bf16_logits", "all_ignored"]


@pytest.mark.parametrize("case", CE_CASES)
def test_cross_entropy_and_grad_match_jax(case):
    """The port's cross_entropy (log-softmax in f32, mean over the labels
    that are not ignored, divided by at least one) equals the JAX
    package's in value and in its gradient to the logits, to 1e-6 (one
    rounding order apart). bf16 logits too: both sides widen them to f32
    first and round the gradient to bf16 once."""
    from paddle_tpu.framework.tensor import Tensor
    from paddle_tpu.nn import functional as jF

    from paddle_tpu_torch.nn import functional as tF

    rng = np.random.RandomState(CE_CASES.index(case))
    logits = (rng.randn(2, 5, 11) * 2).astype(np.float32)
    labels = rng.randint(0, 11, (2, 5)).astype(np.int64)
    kw = {}
    if case == "some_ignored":
        labels[0, :3] = -100
    elif case == "ignore_index_0":
        labels[1, :2] = 0
        kw = dict(ignore_index=0)
    elif case == "label_trailing_1":
        labels = labels[..., None]
    elif case == "all_ignored":
        labels[:] = -100
    bf16 = case == "bf16_logits"
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))

    def jax_loss(lg):
        return jF.cross_entropy(Tensor(lg), Tensor(jnp.asarray(labels)),
                                **kw)._data

    jl, jg = jax.value_and_grad(jax_loss)(jnp.asarray(logits, jdt))
    tl = torch.from_numpy(logits).to(tdt).requires_grad_()
    loss = tF.cross_entropy(tl, torch.from_numpy(labels), **kw)
    loss.backward()
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tl.grad.float().numpy(),
                               np.asarray(jg.astype(jnp.float32)),
                               rtol=1e-6, atol=1e-6)
    if case == "all_ignored":
        assert loss.item() == 0.0 and not tl.grad.any()


@pytest.mark.parametrize("kw", [
    dict(weight=torch.ones(11)), dict(soft_label=True),
    dict(use_softmax=False), dict(label_smoothing=0.1),
    dict(reduction="sum"), dict(axis=0),
], ids=["weight", "soft_label", "no_softmax", "label_smoothing",
        "reduction_sum", "axis_0"])
def test_cross_entropy_options_not_ported_raise(kw):
    """What Llama training does not use is refused, not approximated."""
    from paddle_tpu_torch.nn import functional as tF

    with pytest.raises(NotImplementedError):
        tF.cross_entropy(torch.zeros(2, 3, 11), torch.zeros(2, 3,
                                                             dtype=torch.long),
                         **kw)


def test_accumulate_then_step_equals_one_step_on_both_batches():
    """Gradient merge: ``accumulate(b1)`` then ``step(b2)`` updates with
    grad(b1) + grad(b2), as one step on a loss summed over both batches
    does."""
    cfg = LlamaConfig.tiny(**GEOM)
    a = LlamaForCausalLM(cfg, device="cpu", seed=3)
    b = LlamaForCausalLM(cfg, device="cpu", seed=3)
    (i1, l1), (i2, l2) = (tuple(map(torch.from_numpy, _batch(k, 32)))
                          for k in (1, 2))

    def both(model, *_):
        return llama_loss_fn(model, i1, l1) + llama_loss_fn(model, i2, l2)

    sa = TrainStep(a, AdamW(learning_rate=1e-2), llama_loss_fn)
    sa.accumulate(i1, l1)
    sa(i2, l2)
    TrainStep(b, AdamW(learning_rate=1e-2), both)(None)
    for (n, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        torch.testing.assert_close(pa, pb, atol=1e-6, rtol=1e-5, msg=n)


def test_mask_and_recompute_routes():
    """An ``attn_mask`` takes the plain composition with an additive
    bias (a full mask equals no mask); ``recompute`` is not ported yet
    and raises."""
    tm = LlamaForCausalLM(LlamaConfig.tiny(**GEOM), device="cpu")
    ids = torch.from_numpy(_batch(0, 16)[0])
    with torch.no_grad():
        torch.testing.assert_close(
            tm(ids, attn_mask=torch.ones(2, 16, dtype=torch.bool)), tm(ids))
    tm.config.recompute = True
    with pytest.raises(NotImplementedError, match="recompute"):
        tm(ids)
