"""The Stable-Diffusion UNet in the PyTorch port against the JAX package.

The UNet is built tiny (two levels, narrow widths) with
``attention_head_dim=8``, so its heads are 8 wide as in SD v1.5, in the
JAX package; every JAX parameter is filled with seeded noise (GroupNorm
and LayerNorm weights around one) and carried into the port with
``load_reference_state``, and both take the same numpy inputs on the
CPU, where the port runs the plain versions of its flash kernels. The
JAX side takes its plain attention (``use_flash_attention`` off, a
module fixture): its Pallas path is held against the port in
tests/test_torch_flash_attention.py. The JAX model is built once with
its initialisers patched to zeros (each PRNG draw would compile once per
shape), and one compiled ``paddle_tpu.jit.TrainStep`` gives the JAX
side's prediction (``return_outputs``), loss, every gradient (copied out
of ``grad_postprocess``) and a 3-step AdamW trajectory.

Checked, in f32: the UNet's prediction, ``sd_loss_fn`` and every
gradient (by top-level block); the 3-step AdamW ``TrainStep`` trajectory
(losses and weights); ``timestep_embedding``;
``group_norm`` in f32 and bf16, channels first and last, and the
``GroupNorm`` layer; each simple activation with its layer, values and
gradients; ``interpolate`` in every mode, with and without
``align_corners``, values and gradients; the parameter names; the heads
8 wide (F6); and a bf16 UNet raising in both packages (F5).
"""

import contextlib
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
from paddle_tpu.jit import TrainStep as JTrainStep  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.nn import initializer as jinit  # noqa: E402
from paddle_tpu.nn.functional.activation import _ACTS  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu_torch import TrainStep, load_reference_state  # noqa: E402
from paddle_tpu_torch.models import unet as tunet  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.optimizer import AdamW  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

# f32 on both sides, sums in other orders: the prediction and the loss to
# ATOL + RTOL * |want|, every gradient and the trained weights to
# GRAD_ATOL
ATOL, RTOL = 2e-5, 1e-5
GRAD_ATOL = 1e-4
# SD v1.5's per-head width, as the JAX package reads attention_head_dim
HEAD_DIM = 8


@pytest.fixture(scope="module", autouse=True)
def _jax_plain_attention():
    """The JAX package's plain attention, set for the module (module
    fixtures see it)."""
    before = pt.get_flags(["use_flash_attention"])
    pt.set_flags({"use_flash_attention": False})
    yield
    pt.set_flags(before)


def _cfg():
    return dict(attention_head_dim=HEAD_DIM)


@contextlib.contextmanager
def _zero_jax_init():
    """Every JAX weight is overwritten with seeded noise (``_noisy``), so
    while a JAX model is built its initialisers return zeros, made
    without a compile."""
    def zeros(self, shape, dtype="float32"):
        return jnp.asarray(np.zeros(tuple(shape),
                                    np.dtype(to_jax_dtype(dtype))))

    with contextlib.ExitStack() as stack:
        for cls in (jinit.Constant, jinit.Normal, jinit.Uniform):
            stack.enter_context(mock.patch.object(cls, "__call__", zeros))
        yield


def _jax_unet(seed=0, dtype=jnp.float32):
    """The tiny JAX UNet, every parameter filled with seeded noise in
    ``dtype``: weights 0.1 * N(0, 1), norm weights 1 + 0.1 * N(0, 1)."""
    with _zero_jax_init():
        jm = jmodels.UNet2DConditionModel(jmodels.UNetConfig.tiny(**_cfg()))
    rng = np.random.RandomState(seed)
    for name, p in jm.named_parameters():
        noise = 0.1 * rng.randn(*p.shape).astype(np.float32)
        if name.rsplit(".", 1)[-1] == "weight" and len(p.shape) == 1:
            noise += 1.0
        p._data = jnp.asarray(noise.astype(dtype))
    return jm


def _arrays(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port_unet(arrays):
    tm = tpt.UNet2DConditionModel(tpt.UNetConfig.tiny(**_cfg()),
                                  device="cpu")
    load_reference_state(tm, arrays)
    return tm


def _batch():
    """Latents ``[2, 4, 16, 16]``, timesteps in [0, 1000), a 7-token
    context (a ragged key tile) and the noise target."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 4, 16, 16).astype(np.float32)
    t = np.array([17, 901], np.int64)
    ctx = rng.randn(2, 7, 32).astype(np.float32)
    noise = rng.randn(2, 4, 16, 16).astype(np.float32)
    return x, t, ctx, noise


def _committed(a):
    """``a`` on the JAX device, committed: the JAX TrainStep's outputs are
    committed, and a first call on uncommitted inputs would compile the
    step a second time."""
    return jax.device_put(jnp.asarray(a), jax.devices()[0])


def _with_prediction(sd_loss_fn):
    """A TrainStep ``loss_fn`` (with ``return_outputs``) around the
    package's ``sd_loss_fn``: ``(loss, the model's prediction)``."""
    def loss_fn(model, *batch):
        preds = []

        def record(*args):
            preds.append(model(*args))
            return preds[-1]
        return sd_loss_fn(record, *batch), preds[0]
    return loss_fn


# Adam divides each update by sqrt(v) + epsilon: at the default 1e-8 an
# element whose gradient is near zero moves by up to a learning rate on
# the rounding of that gradient, which the two frameworks do not share.
EPS = 1e-4
ADAMW = dict(learning_rate=1e-3, epsilon=EPS, weight_decay=0.01)
STEPS = 3


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side, from one compiled step: the tiny UNet (noisy
    weights) trained 3 AdamW steps by ``paddle_tpu.jit.TrainStep`` over
    ``sd_loss_fn``; the first step's prediction (``return_outputs``) and
    every gradient (copied to the host from ``grad_postprocess``), the
    losses, and the weights before and after."""
    jm = _jax_unet()
    for _, p in jm.named_parameters():
        p._data = _committed(p._data)
    start = _arrays(jm)
    grads = []

    def capture(g):
        jax.debug.callback(lambda host: grads.append(
            {n: np.asarray(a) for n, a in host.items()}), g)
        return g

    step = JTrainStep(jm, jopt.AdamW(parameters=jm.parameters(), **ADAMW),
                      _with_prediction(jmodels.sd_loss_fn),
                      grad_postprocess=capture, return_outputs=True)
    step._init_state()
    step._state = jax.device_put(step._state, jax.devices()[0])
    batch = [pt.to_tensor(_committed(a)) for a in _batch()]
    losses, preds = [], []
    for _ in range(STEPS):
        loss, pred = step(*batch)
        losses.append(float(loss))
        preds.append(np.asarray(pred.numpy()))
    assert len(grads) == STEPS
    return dict(start=start, pred=preds[0], losses=losses, grads=grads[0],
                end=_arrays(jm))


@pytest.fixture(scope="module")
def port_run(jax_run):
    """The port's side on the same weights and batch: its own
    ``sd_loss_fn`` once, then the same 3 AdamW steps through its
    ``TrainStep``, with the first step's prediction and gradients."""
    tm = _port_unet(jax_run["start"])
    batch = [torch.from_numpy(a) for a in _batch()]
    with torch.no_grad():
        loss = float(tpt.sd_loss_fn(tm, *batch))
    grads = []

    def capture(g):
        grads.append({n: v.clone().numpy() for n, v in g.items()})
        return g

    step = TrainStep(tm, AdamW(**ADAMW), _with_prediction(tpt.sd_loss_fn),
                     grad_postprocess=capture, return_outputs=True)
    losses, preds = [], []
    for _ in range(STEPS):
        step_loss, pred = step(*batch)
        losses.append(float(step_loss))
        preds.append(pred.numpy())
    return dict(loss=loss, pred=preds[0], losses=losses, grads=grads[0],
                end={n: p.detach().numpy() for n, p in tm.named_parameters()})


def test_forward_matches_jax(jax_run, port_run):
    want, got = jax_run["pred"], port_run["pred"]
    assert got.shape == want.shape == (2, 4, 16, 16)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_sd_loss_matches_jax(jax_run, port_run):
    """The port's ``sd_loss_fn`` on the starting weights, and its
    TrainStep's first loss, against the JAX step's first loss."""
    for got in (port_run["loss"], port_run["losses"][0]):
        np.testing.assert_allclose(got, jax_run["losses"][0], atol=ATOL,
                                   rtol=RTOL)


def _top_blocks():
    """The tiny UNet's top-level blocks, the gradients' groups."""
    model = tunet.UNet2DConditionModel(tunet.UNetConfig.tiny(**_cfg()),
                                       device="cpu")
    return sorted({n.split(".")[0] for n, _ in model.named_parameters()})


@pytest.mark.parametrize("block", _top_blocks())
def test_every_gradient_matches_jax(jax_run, port_run, block):
    """Every parameter's gradient of the first step by name, grouped by
    the top-level block: the same names on both sides."""
    jgrads, tgrads = jax_run["grads"], port_run["grads"]
    assert set(tgrads) == set(jgrads)
    names = [n for n in tgrads if n.split(".")[0] == block]
    assert names
    for n in names:
        np.testing.assert_allclose(tgrads[n], jgrads[n], atol=GRAD_ATOL,
                                   rtol=0, err_msg=n)


def test_parameter_names_and_heads_match_jax(jax_run):
    """The port's names and shapes are the JAX ``state_dict()``'s, with
    the blocks under ``{list}_{block}_{layer}``; ``attention_head_dim``
    is the per-head width in both (F6): 32 channels run 4 heads of 8."""
    arrays = jax_run["start"]
    tm = _port_unet(arrays)
    with _zero_jax_init():
        jm = jmodels.UNet2DConditionModel(jmodels.UNetConfig.tiny(**_cfg()))
    got = {n: tuple(p.shape) for n, p in tm.state_dict().items()}
    assert got == {n: a.shape for n, a in arrays.items()}
    for n in ("conv_in.weight", "time_mlp1.weight",
              "down_res_0_0.norm1.weight", "mid_attn.attn2.to_k.weight",
              "up_sample_0.conv.weight"):
        assert n in got
    attn = tm.down_attn_0_0.attn1
    jattn = jm.down_attn[0][0].attn1
    assert (attn.heads, attn.head_dim) == (jattn.heads, jattn.head_dim) \
        == (4, HEAD_DIM)


def test_trainstep_trajectory_matches_jax(jax_run, port_run):
    """3 AdamW steps (f32, weight decay): the losses to ATOL + RTOL and
    the final weights to GRAD_ATOL against the JAX TrainStep."""
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"],
                               atol=ATOL, rtol=RTOL)
    assert port_run["losses"][-1] < port_run["losses"][0]
    assert set(port_run["end"]) == set(jax_run["end"])
    for n, got in port_run["end"].items():
        np.testing.assert_allclose(got, jax_run["end"][n], atol=GRAD_ATOL,
                                   rtol=0, err_msg=n)


@pytest.mark.parametrize("dim", [32, 320])
def test_timestep_embedding_matches_jax(dim):
    """f32 ``[cos, sin]`` embeddings of integer timesteps in [0, 1000),
    as SD's trainer draws them, and of f32 ones. The two packages' ``exp``
    give the frequencies (all at most 1) to an f32 ulp, 2^-24, which the
    timestep multiplies: a row of timestep t is held to ATOL + t 2^-24
    (+ RTOL of the value); timestep 0 and 1 to ATOL alone."""
    t = np.array([0, 1, 17, 500, 999], np.int64)
    for ts in (t, t.astype(np.float32) + 0.25):
        want = np.asarray(jmodels.timestep_embedding(pt.to_tensor(ts),
                                                     dim)._data)
        got = tunet.timestep_embedding(torch.from_numpy(ts), dim)
        assert got.dtype == torch.float32 and got.shape == (5, dim)
        err = np.abs(got.numpy() - want)
        tol = (ATOL + np.abs(ts.astype(np.float64))[:, None] * 2.0 ** -24
               + RTOL * np.abs(want))
        assert (err <= tol).all(), float((err - tol).max())
        np.testing.assert_allclose(got.numpy()[:2], want[:2], atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_jax(dtype, data_format):
    """Statistics and affine in f32, cast to the input dtype: f32 to
    ATOL + RTOL, bf16 to one bf16 rounding of the largest value; the
    ``GroupNorm`` layer gives the functional's result."""
    rng = np.random.RandomState(4)
    shape = (2, 12, 5, 6) if data_format == "NCHW" else (2, 5, 6, 12)
    x = (2.0 * rng.randn(*shape) + 0.5).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(12)).astype(np.float32)
    b = (0.1 * rng.randn(12)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)

    def jt(a):
        return pt.to_tensor(jnp.asarray(a, jdt))

    def tt(a):
        return torch.from_numpy(a).to(tdt)

    want = np.asarray(JF.group_norm(jt(x), 3, 1e-5, jt(w), jt(b),
                                    data_format)._data.astype(jnp.float32))
    got = TF.group_norm(tt(x), 3, 1e-5, tt(w), tt(b), data_format)
    assert got.dtype == tdt and tuple(got.shape) == shape
    tol = (dict(atol=ATOL, rtol=RTOL) if dtype == "float32" else
           dict(atol=2.0 ** -8 * float(np.abs(want).max()), rtol=0))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    layer = tpt.nn.GroupNorm(3, 12, epsilon=1e-5, data_format=data_format,
                             device="cpu", dtype=tdt)
    with torch.no_grad():
        layer.weight.copy_(tt(w))
        layer.bias.copy_(tt(b))
    assert torch.equal(layer(tt(x)), got)
    bare = TF.group_norm(tt(x), 3, data_format=data_format)
    jbare = np.asarray(JF.group_norm(jt(x), 3, data_format=data_format)
                       ._data.astype(jnp.float32))
    np.testing.assert_allclose(bare.float().numpy(), jbare, **tol)


# the simple activations: the JAX package's name -> (its body, the port's
# layer)
ACTIVATIONS = {
    **{name: (fn, name) for name, fn in _ACTS.items()},
    "logsigmoid": (jax.nn.log_sigmoid, "logsigmoid"),
}
LAYERS = {"relu": "ReLU", "relu6": "ReLU6", "sigmoid": "Sigmoid",
          "tanh": "Tanh", "silu": "Silu", "swish": "Swish", "mish": "Mish",
          "softsign": "Softsign", "tanhshrink": "Tanhshrink",
          "hardswish": "Hardswish", "logsigmoid": "LogSigmoid"}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activation_matches_jax(name):
    """Values and gradients of ``F.<name>`` against the JAX package's
    body on points across [-8, 8] (off the kinks at -3, 0, 3 and 6) and
    large magnitudes; the layer of the same name gives the functional's
    result."""
    x = np.concatenate([np.linspace(-8, 8, 161) + 0.013,
                        [-60.0, -25.0, 25.0, 60.0]]).astype(np.float32)
    body = ACTIVATIONS[name][0]
    pkg, want, dwant = map(np.asarray, jax.jit(lambda v: (
        getattr(JF, name)(pt.to_tensor(v))._data, body(v),
        jax.grad(lambda u: body(u).sum())(v)))(jnp.asarray(x)))
    assert pkg.tolist() == want.tolist()
    xt = torch.from_numpy(x).requires_grad_()
    got = getattr(TF, name)(xt)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), dwant, atol=ATOL, rtol=RTOL)
    layer = getattr(tpt.nn, LAYERS[name])()
    assert torch.equal(layer(xt.detach()), got.detach())


# (mode, input shape, size, scale_factor, data_format)
INTERP = [
    ("nearest", (2, 3, 5, 7), None, 2.0, "NCHW"),
    ("nearest", (2, 5, 7, 3), (3, 11), None, "NHWC"),
    ("linear", (2, 3, 9), (14,), None, "NCW"),
    ("bilinear", (2, 3, 5, 7), (8, 4), None, "NCHW"),
    ("bilinear", (2, 5, 7, 3), None, (1.5, 2.0), "NHWC"),
    ("trilinear", (1, 2, 3, 4, 5), (5, 2, 7), None, "NCDHW"),
    ("bicubic", (2, 3, 6, 5), (9, 4), None, "NCHW"),
    ("area", (2, 3, 9, 8), (4, 3), None, "NCHW"),
]


@pytest.mark.parametrize("align_corners", [False, True],
                         ids=["half_pixel", "align_corners"])
@pytest.mark.parametrize("case", INTERP,
                         ids=lambda c: f"{c[0]}_{c[4]}_{c[2] or c[3]}")
def test_interpolate_matches_jax(case, align_corners):
    """``F.interpolate`` against the JAX package's in each mode, sizes up
    and down, channels first and last: values, and the gradient of a
    weighted sum; ``upsample`` and the ``Upsample`` layer give the same
    result. Area ignores ``align_corners``, as in the JAX package."""
    mode, shape, size, scale, fmt = case
    rng = np.random.RandomState(5)
    x = rng.randn(*shape).astype(np.float32)
    args = dict(size=list(size) if size else None, scale_factor=scale,
                mode=mode, align_corners=align_corners, data_format=fmt)

    def jax_fn(v):
        return JF.interpolate(pt.to_tensor(v), **args)._data

    cot = rng.randn(*jax.eval_shape(jax_fn, jnp.asarray(x)).shape).astype(
        np.float32)
    want, dwant = map(np.asarray, jax.jit(lambda v: (
        jax_fn(v), jax.grad(lambda u: (jax_fn(u) * cot).sum())(v)))(
            jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    got = TF.interpolate(xt, **args)
    (got * torch.from_numpy(cot)).sum().backward()
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(xt.grad.numpy(), dwant, atol=ATOL, rtol=RTOL)
    x0 = xt.detach()
    assert torch.equal(TF.upsample(x0, **args), got.detach())
    assert torch.equal(tpt.nn.Upsample(**args)(x0), got.detach())


def test_interpolate_keeps_bf16_per_axis():
    """bf16 input: each axis' product in f32, cast back to bf16 before
    the next axis, as the JAX body rounds (to one bf16 rounding of the
    largest value: the f32 sums may fall either side of a rounding
    point); area's product stays f32 in both (to ATOL + RTOL)."""
    rng = np.random.RandomState(6)
    x = rng.randn(1, 2, 6, 5).astype(np.float32)
    for mode, size in (("bilinear", [9, 7]), ("area", [3, 2])):
        want = JF.interpolate(pt.to_tensor(jnp.asarray(x, jnp.bfloat16)),
                              size=size, mode=mode)._data
        got = TF.interpolate(torch.from_numpy(x).to(torch.bfloat16),
                             size=size, mode=mode)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        want = np.asarray(want.astype(jnp.float32))
        tol = (dict(atol=ATOL, rtol=RTOL) if mode == "area" else
               dict(atol=2.0 ** -8 * float(np.abs(want).max()), rtol=0))
        np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_bf16_unet_raises_in_both_packages(jax_run):
    """F5: neither package has a bf16 UNet without amp. The f32 timestep
    embedding meets the bf16 weights: the JAX package promotes ``h`` to
    f32 and its conv then refuses f32 against bf16 (raised while the
    forward is traced, so nothing compiles); the port's matmul refuses
    at ``time_mlp1``. Both raise."""
    x, t, ctx, _ = _batch()
    jm = _jax_unet(seed=2, dtype=jnp.bfloat16)

    def forward(x, t, ctx):
        return jm(*map(pt.to_tensor, (x, t, ctx)))._data

    with pytest.raises(TypeError, match="same dtypes"):
        jax.jit(forward)(jnp.asarray(x, jnp.bfloat16), jnp.asarray(t),
                         jnp.asarray(ctx, jnp.bfloat16))
    tm = _port_unet(jax_run["start"]).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="dtype"):
        tm(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(t),
           torch.from_numpy(ctx).to(torch.bfloat16))


def test_unet_runs_zero_padded_heads_through_the_flash_function():
    """The port's attention at head_dim 8 goes through the flash kernels'
    autograd Function, not a composition of its own: on the CPU its
    plain versions, on the card K1-K4 at d=8 zero-padded to 64."""
    from paddle_tpu_torch.ops.hopper import flash_attention as hop_fa

    calls = []
    real = hop_fa.FlashAttentionFunction.apply

    def spy(q, k, v, causal, scale):
        calls.append((tuple(q.shape), tuple(k.shape), causal, scale))
        return real(q, k, v, causal, scale)

    tm = tpt.UNet2DConditionModel(tpt.UNetConfig.tiny(**_cfg()),
                                  device="cpu", seed=3)
    x, t, ctx, _ = map(torch.from_numpy, _batch())
    with mock.patch.object(hop_fa.FlashAttentionFunction, "apply", spy):
        tm(x, t, ctx)
    # one TransformerBlock at 16^2 going down, one in the middle at 8^2,
    # two at 16^2 coming up: self- then cross-attention each
    assert [c[:2] for c in calls] == [
        ((2, 256, 4, 8), (2, 256, 4, 8)), ((2, 256, 4, 8), (2, 7, 4, 8)),
        ((2, 64, 8, 8), (2, 64, 8, 8)), ((2, 64, 8, 8), (2, 7, 8, 8)),
    ] + [((2, 256, 4, 8), (2, 256, 4, 8)), ((2, 256, 4, 8), (2, 7, 4, 8))] * 2
    assert all(not c[2] and c[3] == 1 / math.sqrt(HEAD_DIM) for c in calls)
    assert hop_fa.padded_head_dim(HEAD_DIM) == 64
