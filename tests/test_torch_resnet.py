"""ResNet training in the PyTorch port against the JAX package.

A ``[1, 1, 1, 1]``-depth ``ResNet(BottleneckBlock)`` (10 classes, 64^2
inputs, batch 2) is built in the JAX package and its weights and
BatchNorm buffers are carried into the port with ``load_reference_state``;
both take the same numpy batch on the CPU, where the port runs the plain
versions of its kernels. The JAX side of each case is one compiled
function (``jax.jit`` or ``paddle_tpu.jit.TrainStep``): eager JAX runs a
training step of this model several times slower.

Checked: (a) with the flags off, in f32, the logits, loss, every gradient
and every running statistic after one training forward, and the conv,
norm and pool layers' NCHW API; (b) the fused
composition of one block in f32 against the JAX package's
``_forward_fused``; with both ResNet flags on, in bf16, the route of
every block (fused or not, K8 or a PyTorch 3x3, K9 or plain statistics)
and a 2-step ``TrainStep`` + ``Momentum`` trajectory; ResNet-50's routes
at full width; (c) Momentum's update options and its ``multi_precision``
quirk (ROADMAP queue 3, F3); (d) ``load_reference_state`` with buffers.
"""

import functools

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import jax  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import nn as jnn  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.jit import TrainStep as JTrainStep  # noqa: E402
from paddle_tpu.jit.functional import (  # noqa: E402
    call_functional, get_buffers, get_params)
from paddle_tpu.ops.pallas import bn_stats as jbn_stats  # noqa: E402
from paddle_tpu.vision.models.resnet import (  # noqa: E402
    BottleneckBlock as JBottleneck)
from paddle_tpu.vision.models.resnet import ResNet as JResNet  # noqa: E402
from paddle_tpu_torch import TrainStep, flags, load_reference_state  # noqa
from paddle_tpu_torch.nn import CrossEntropyLoss  # noqa: E402
from paddle_tpu_torch.ops.hopper import bn_stats as hop_bn  # noqa: E402
from paddle_tpu_torch.optimizer import Momentum  # noqa: E402
from paddle_tpu_torch.vision.models import (  # noqa: E402
    BottleneckBlock, ResNet, resnet50)

DEPTH = [1, 1, 1, 1]
CLASSES, BATCH, SIZE = 10, 2, 64
RESNET_FLAGS = ("use_fused_resnet_unit", "use_pallas_bn_stats")


@pytest.fixture(autouse=True)
def jax_direct_stem():
    """The port's stem is the direct 7x7/s2 convolution; the JAX model
    takes its own direct stem too (its space-to-depth form computes the
    same function in another summation order, and a last-bit difference
    at a max-pool or relu tie moves the stem's weight gradient by 1.5e-3
    of its largest element)."""
    before = pt.get_flags("resnet_space_to_depth")
    pt.set_flags({"resnet_space_to_depth": False})
    yield
    pt.set_flags(before)


@pytest.fixture
def resnet_flags():
    """Sets both ResNet flags in both packages; restores them after."""
    before = (pt.get_flags(list(RESNET_FLAGS)),
              flags.get_flags(list(RESNET_FLAGS)))

    def set_(on):
        pt.set_flags({k: on for k in RESNET_FLAGS})
        flags.set_flags({k: on for k in RESNET_FLAGS})
    yield set_
    pt.set_flags(before[0])
    flags.set_flags(before[1])


def _jax_model(bf16=False):
    pt.seed(3)
    jm = JResNet(JBottleneck, DEPTH, num_classes=CLASSES)
    if bf16:
        # as bench.py's _bf16_params: parameters bf16, buffers f32
        for _, p in jm.named_parameters():
            p._data = p._data.astype(jnp.bfloat16)
    jm.train()
    return jm


def _state(jm):
    """Parameters and buffers as f32 numpy arrays (bf16 widens exactly)."""
    return {k: np.asarray(v._data.astype(jnp.float32))
            for k, v in jm.state_dict().items()}


def _port_model(jm, dtype="float32"):
    tm = ResNet(BottleneckBlock, DEPTH, num_classes=CLASSES, device="cpu",
                dtype=dtype)
    load_reference_state(tm, _state(jm))
    tm.train()
    return tm


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(BATCH, 3, SIZE, SIZE).astype(np.float32)
    y = rng.randint(0, CLASSES, (BATCH,)).astype(np.int64)
    return x, y


def _max_rel(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


@functools.lru_cache(maxsize=None)
def _jax_f32_step():
    """The JAX model's logits, loss, gradients and updated buffers after
    one training forward in f32 (flags off), in one jitted function."""
    jm = _jax_model()
    x, y = _batch()
    ce = jnn.CrossEntropyLoss()

    def loss_of(params, buffers, xv, yv):
        logits, new_buf = call_functional(
            jm, params, buffers, (pt.to_tensor(xv),), {}, train=True)
        loss = ce(pt.to_tensor(logits), pt.to_tensor(yv))
        return loss._data, (logits, new_buf)

    fn = jax.jit(jax.value_and_grad(loss_of, has_aux=True))
    (loss, (logits, new_buf)), grads = fn(get_params(jm), get_buffers(jm),
                                          jnp.asarray(x), jnp.asarray(y))
    return _state(jm), (x, y), loss, logits, new_buf, grads


def test_resnet_f32_flags_off_matches_jax():
    """f32, the default composition: logits and loss to 1e-5 relative,
    every gradient and running statistic to 1e-4 of its largest element
    (the same f32 arithmetic in other summation orders: convolutions
    over up to 4,608 terms, BatchNorm statistics over up to 2,048
    positions)."""
    assert not flags.flag_value("use_fused_resnet_unit")
    state, (x, y), jloss, jlogits, jbuf, jgrads = _jax_f32_step()
    tm = _port_model(_jax_model())
    load_reference_state(tm, state)
    logits = tm(torch.from_numpy(x))
    loss = CrossEntropyLoss()(logits, torch.from_numpy(y))
    loss.backward()
    assert _max_rel(logits, jlogits) <= 1e-5
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    params = dict(tm.named_parameters())
    assert set(params) == set(jgrads) and len(params) == 53
    for n, p in params.items():
        assert _max_rel(p.grad, jgrads[n]) <= 1e-4, n
    buffers = dict(tm.named_buffers())
    assert set(buffers) == set(jbuf) and len(buffers) == 34
    for n, b in buffers.items():
        assert b.dtype == torch.float32
        assert _max_rel(b, jbuf[n]) <= 1e-4, n


NCHW_LAYERS = {
    # case: (layer, arguments, whether the port's layer holds tensors)
    "conv2d_s2_p1_bias": ("Conv2D", (6, 8, 3), dict(stride=2, padding=1),
                          True),
    "batch_norm_train": ("BatchNorm2D", (6,), {}, True),
    "max_pool_3_s2_p1": ("MaxPool2D", (3,), dict(stride=2, padding=1),
                         False),
    "adaptive_avg_pool_2": ("AdaptiveAvgPool2D", (2,), {}, False),
}


@pytest.mark.parametrize("case", sorted(NCHW_LAYERS))
def test_layers_nchw_api_match_jax(case):
    """The conv, norm and pool layers keep Paddle's NCHW API and compute
    channel-last inside (``nhwc_compute``): each layer's f32 output, and
    BatchNorm's running statistics after a training forward, equal the
    JAX layer's on the same NCHW input to 1e-5 of the largest element
    (summation order)."""
    from paddle_tpu import nn as jlayers

    from paddle_tpu_torch import nn as tlayers

    name, args, kw, holds = NCHW_LAYERS[case]
    pt.seed(11)
    jl = getattr(jlayers, name)(*args, **kw)
    tl = getattr(tlayers, name)(*args, **kw,
                                **(dict(device="cpu") if holds else {}))
    state = _state(jl)
    load_reference_state(tl, state)
    jl.train()
    tl.train()
    x = np.random.RandomState(4).randn(2, 6, 9, 9).astype(np.float32)
    want = np.asarray(jl(pt.to_tensor(x))._data)
    got = tl(torch.from_numpy(x))
    assert got.shape == want.shape
    assert _max_rel(got, want) <= 1e-5
    jbuf = {k: v for k, v in _state(jl).items() if k not in
            dict(tl.named_parameters())}
    buffers = dict(tl.named_buffers())
    assert set(buffers) == set(jbuf)
    for n, b in buffers.items():
        assert _max_rel(b, jbuf[n]) <= 1e-5, n


def test_resnet_computes_channel_last_in_memory():
    """The NCHW input is copied channel-last once at the model's edge, so
    the stem, the max pool and every stage give tensors whose NHWC view
    is contiguous (channels-last memory). A channel-last view of NCHW
    memory would carry NCHW memory through every convolution after it,
    and BatchNorm and the elementwise passes would stride across
    channels."""
    tm = ResNet(BottleneckBlock, DEPTH, num_classes=CLASSES, device="cpu")
    tm.train()
    names = ("conv1", "bn1", "maxpool", "layer1", "layer2", "layer3",
             "layer4")
    contiguous = {}
    for name in names:
        getattr(tm, name).register_forward_hook(
            lambda mod, inp, out, name=name: contiguous.__setitem__(
                name, out.is_contiguous()))
    x, _ = _batch()
    with torch.no_grad():
        tm(torch.from_numpy(x))
    assert contiguous == {name: True for name in names}


# block input shapes [n, h, w, c] at 64^2, batch 2: the stem and the
# max pool take 64 -> 16
BLOCK_INPUTS = {"layer1": (BATCH, 16, 16, 64), "layer2": (BATCH, 16, 16, 256),
                "layer3": (BATCH, 8, 8, 512), "layer4": (BATCH, 4, 4, 1024)}


def test_resnet_routes_match_jax_with_flags_on(resnet_flags):
    """With both flags on and bf16 parameters, every block takes the
    same route in both packages: layers 1-2 fused (K8 in layer 1, a
    PyTorch/XLA 3x3 for layer 2's stride 2), layers 3-4 the composition;
    the training BatchNorms K9 takes are the same (the four downsample
    BNs and the composition blocks' BNs with C % 128 == 0)."""
    from paddle_tpu.ops.pallas.resnet_unit import supported_3x3

    resnet_flags(True)
    jm = _jax_model(bf16=True)
    tm = _port_model(jm, "bfloat16")
    routes = {}
    for name, shape in BLOCK_INPUTS.items():
        zeros = np.zeros(shape, np.float32)
        jblk, tblk = getattr(jm, name)[0], getattr(tm, name)[0]
        jfused = jblk._fused_ok(pt.to_tensor(zeros.astype("bfloat16")))
        tfused = tblk._fused_ok(torch.from_numpy(zeros).bfloat16())
        assert jfused == tfused, name
        n, h, w, _ = shape
        width = jblk.conv1.weight.shape[0]
        jk8 = jblk._stride == 1 and supported_3x3(n, h, w, width, width)
        assert tblk._uses_3x3_kernel(torch.zeros(shape)) == jk8, name
        routes[name] = (tfused, jk8)
    assert routes == {"layer1": (True, True), "layer2": (True, False),
                      "layer3": (False, False), "layer4": (False, False)}

    # K9's call sites: count them in one forward of each package
    calls = {"jax": 0, "port": 0}
    jax_bn_stats, port_bn_ref = jbn_stats.bn_stats, hop_bn.bn_stats_reference

    def count(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    x, _ = _batch()
    try:
        jbn_stats.bn_stats = count("jax", jax_bn_stats)
        hop_bn.bn_stats_reference = count("port", port_bn_ref)
        jax.jit(lambda p, b, v: call_functional(
            jm, p, b, (pt.to_tensor(v),), {}, train=True)[0]).lower(
                get_params(jm), get_buffers(jm),
                jnp.asarray(x, jnp.bfloat16))
        with torch.no_grad():
            tm(torch.from_numpy(x).bfloat16())
    finally:
        jbn_stats.bn_stats, hop_bn.bn_stats_reference = (jax_bn_stats,
                                                         port_bn_ref)
    assert calls["port"] == calls["jax"] == 10


def _blocks(stride):
    """A JAX BottleneckBlock (NHWC, f32) and the port's with its weights:
    64 -> 64 -> 64 at stride 1 (K8's route), 64 -> 64 -> 128 with a
    downsample at stride 2 (a 3x3 convolution plus plain statistics)."""
    from paddle_tpu.nn.layer import BatchNorm2D as JBN
    from paddle_tpu.nn.layer import Conv2D as JConv
    from paddle_tpu.nn.layer import Sequential as JSeq

    from paddle_tpu_torch.nn import BatchNorm2D, Conv2D

    planes, bw = (16, 256) if stride == 1 else (32, 128)
    pt.seed(7 + stride)
    jdown = tdown = None
    if stride == 2:
        jdown = JSeq(JConv(64, 128, 1, stride=2, bias_attr=False,
                           data_format="NHWC"),
                     JBN(128, data_format="NHWC"))
        tdown = torch.nn.Sequential(
            Conv2D(64, 128, 1, stride=2, bias_attr=False, data_format="NHWC",
                   device="cpu"),
            BatchNorm2D(128, data_format="NHWC", device="cpu"))
    jblk = JBottleneck(64, planes, stride=stride, downsample=jdown,
                       base_width=bw, data_format="NHWC")
    tblk = BottleneckBlock(64, planes, stride=stride, downsample=tdown,
                           base_width=bw, data_format="NHWC", device="cpu")
    jblk.train()
    tblk.train()
    load_reference_state(tblk, _state(jblk))
    return jblk, tblk


@pytest.mark.parametrize("stride", [1, 2])
def test_bottleneck_fused_composition_matches_jax_f32(stride):
    """The fused composition itself (``_forward_fused``: K7, K8 or the 3x3
    convolution with plain statistics, the BatchNorm coefficients from
    the epilogue sums, the folded scale/shift, the running statistics)
    in f32, where every rounding cast is exact: the output, the input's
    and every parameter's gradient, and every running statistic, to 1e-4
    of each one's largest element (other summation orders)."""
    from paddle_tpu.framework.autograd import no_grad
    from paddle_tpu.jit.functional import swap_state

    jblk, tblk = _blocks(stride)
    rng = np.random.RandomState(stride)
    x = rng.randn(BATCH, 16, 16, 64).astype(np.float32)
    cot = rng.randn(BATCH, 16 // stride, 16 // stride,
                    128 if stride == 2 else 64).astype(np.float32)
    assert tblk._uses_3x3_kernel(torch.from_numpy(x)) == (stride == 1)

    def loss_of(params, xv, buffers):
        with swap_state(jblk, params, buffers) as mutated:
            with no_grad():
                out = jblk._forward_fused(pt.to_tensor(xv))._data
        return jnp.vdot(out, cot), (out, mutated)

    (_, (jout, jbuf)), (jgrads, jdx) = jax.jit(jax.value_and_grad(
        loss_of, argnums=(0, 1), has_aux=True))(
            get_params(jblk), jnp.asarray(x), get_buffers(jblk))
    xt = torch.from_numpy(x).requires_grad_()
    out = tblk._forward_fused(xt)
    out.backward(torch.from_numpy(cot))
    assert _max_rel(out, jout) <= 1e-4
    assert _max_rel(xt.grad, jdx) <= 1e-4
    params = dict(tblk.named_parameters())
    assert set(params) == set(jgrads)
    for n, p in params.items():
        assert _max_rel(p.grad, jgrads[n]) <= 1e-4, n
    buffers = dict(tblk.named_buffers())
    assert set(buffers) == set(jbuf)
    for n, b in buffers.items():
        assert _max_rel(b, jbuf[n]) <= 1e-4, n


def test_resnet_bf16_fused_trainstep_matches_jax(resnet_flags):
    """Both flags on, bf16 parameters with f32 Momentum masters
    (momentum 0.9): two TrainSteps of each package on the same batch, at
    a rate (1e-3) that takes the loss from ~2.2 to ~0.6 and so keeps it
    far from zero. The two frameworks round bf16 at other places (XLA
    fuses and rounds once where PyTorch rounds per operation; products
    sum in other orders), and this two-image model's bf16 gradients are
    dominated by that rounding: the JAX package's own bf16 gradients
    differ from its f32 ones by ~36% in norm, and the port's from the JAX
    package's by ~30%. So the check is: losses to 3e-2 relative (forward
    quantities: the first agrees to 1e-4); the masters' total update
    (all parameters) to half its norm, which a dropped term or a wrong
    sign exceeds; each parameter's update norm to between 0.8 and 1.25
    of the JAX package's (measured: 0.91 to 1.03), which a scale error
    of a quarter exceeds; and the running statistics to 5e-2 of each
    one's largest element. Exact agreement of the fused composition
    is checked in f32 above."""
    resnet_flags(True)
    jm = _jax_model(bf16=True)
    tm = _port_model(jm, "bfloat16")
    init = _state(jm)
    jce, tce = jnn.CrossEntropyLoss(), CrossEntropyLoss()
    jstep = JTrainStep(jm, jopt.Momentum(
        learning_rate=1e-3, momentum=0.9, parameters=jm.parameters(),
        multi_precision=True), lambda m, v, y: jce(m(v), y))
    tstep = TrainStep(tm, Momentum(learning_rate=1e-3, momentum=0.9,
                                   multi_precision=True),
                      lambda m, v, y: tce(m(v), y))
    x, y = _batch(1)
    xb = x.astype("bfloat16")
    jl = [float(jstep(pt.to_tensor(xb), pt.to_tensor(y))) for _ in range(2)]
    tl = [float(tstep(torch.from_numpy(x).bfloat16(), torch.from_numpy(y)))
          for _ in range(2)]
    np.testing.assert_allclose(tl, jl, rtol=3e-2)
    assert tl[1] < 0.5 * tl[0] and jl[1] > 0.1
    want = {n: np.asarray(a) for n, a in jstep._state["master"].items()}
    got = tstep._master
    assert set(got) == set(want) and len(got) == 53
    assert all(m.dtype == torch.float32 for m in got.values())
    names = sorted(want)
    du_t = np.concatenate([got[n].numpy().ravel() - init[n].ravel()
                           for n in names])
    du_j = np.concatenate([want[n].ravel() - init[n].ravel() for n in names])
    assert np.linalg.norm(du_t - du_j) <= 0.5 * np.linalg.norm(du_j)
    for n in names:
        ratio = (np.linalg.norm(got[n].numpy() - init[n])
                 / np.linalg.norm(want[n] - init[n]))
        assert 0.8 <= ratio <= 1.25, (n, ratio)
    jbuf = get_buffers(jm)
    for n, b in tm.named_buffers():
        assert _max_rel(b, jbuf[n]) <= 5e-2, n


MOMENTUM_CASES = {
    "plain": dict(),
    "nesterov": dict(use_nesterov=True),
    "l2_decay": dict(weight_decay=0.1),
    "nesterov_l2_decay_m05": dict(use_nesterov=True, weight_decay=0.05,
                                  momentum=0.5),
}


@pytest.mark.parametrize("case", sorted(MOMENTUM_CASES))
def test_momentum_update_options_match_jax(case):
    """Three f32 updates under each option equal the JAX package's
    ``_update`` to 1e-6 (one rounding order apart)."""
    kw = dict(learning_rate=1e-2, **MOMENTUM_CASES[case])
    rng = np.random.RandomState(5)
    w = rng.randn(8, 16).astype(np.float32)
    grads = [rng.randn(8, 16).astype(np.float32) for _ in range(3)]
    jo = jopt.Momentum(parameters=[], **kw)
    to = Momentum(**kw)
    jw, tw = jnp.asarray(w), torch.from_numpy(w.copy())
    js, ts = jo._init_slots(jw), to._init_slots(tw)
    for step, g in enumerate(grads, 1):
        jw, js = jo._update(jw, jnp.asarray(g), js, 1e-2, step)
        to._update(tw, torch.from_numpy(g), ts, 1e-2, step)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(ts["velocity"].numpy(),
                               np.asarray(js["velocity"]), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("mp", [False, True, None])
def test_momentum_always_keeps_f32_masters_as_the_reference_does(mp):
    """F3: the JAX package's Momentum swallows ``multi_precision`` in its
    keyword arguments, so f32 masters are on whatever the caller passes.
    The port reproduces it (so that the two train alike) and this pins
    it, in both packages, until the reference is settled."""
    kw = {} if mp is None else dict(multi_precision=mp)
    assert jopt.Momentum(parameters=[], **kw)._multi_precision is True
    assert Momentum(**kw)._multi_precision is True


def test_load_reference_state_loads_and_checks_buffers():
    """Buffers load by name like parameters (87 entries at this depth);
    a missing or an unknown buffer is refused before anything is
    written."""
    jm = _jax_model()
    state = _state(jm)
    assert len(state) == 87
    state["layer1.0.downsample.1._mean"] = np.full(256, 0.25, np.float32)
    tm = ResNet(BottleneckBlock, DEPTH, num_classes=CLASSES, device="cpu",
                dtype="bfloat16")
    load_reference_state(tm, state)
    mean = dict(tm.named_buffers())["layer1.0.downsample.1._mean"]
    assert mean.dtype == torch.float32 and bool((mean == 0.25).all())
    assert tm.conv1.weight.dtype == torch.bfloat16
    before = tm.conv1.weight.detach().clone()
    missing = {k: v for k, v in state.items() if k != "bn1._variance"}
    with pytest.raises(KeyError, match="bn1._variance"):
        load_reference_state(tm, dict(missing, **{"conv1.weight":
                                                  state["conv1.weight"] + 1}))
    with pytest.raises(KeyError, match="extra"):
        load_reference_state(tm, dict(state, **{"bn1._count": np.zeros(1)}))
    assert torch.equal(tm.conv1.weight, before)


def test_trainstep_updates_batchnorm_buffers_once_per_call():
    """``accumulate()`` and ``__call__`` each run one training forward, so
    each updates the running statistics once, as the JAX step writes
    back the buffers of its forward: from zeros, Paddle's momentum 0.9
    gives 0.1 m after the first and 0.19 m after the second (m the batch
    mean), and the weights do not move at a zero rate."""
    from paddle_tpu_torch.nn import BatchNorm2D, Conv2D

    torch.manual_seed(0)
    model = torch.nn.Sequential(
        Conv2D(3, 8, 3, padding=1, data_format="NHWC", device="cpu"),
        BatchNorm2D(8, data_format="NHWC", device="cpu"))
    model.train()
    x = torch.randn(2, 6, 6, 3)
    with torch.no_grad():
        m = model[0](x).mean(dim=(0, 1, 2))
    w0 = model[0].weight.detach().clone()
    step = TrainStep(model, Momentum(learning_rate=0.0),
                     lambda mdl, v: mdl(v).square().mean())
    step.accumulate(x)
    torch.testing.assert_close(model[1]._mean, 0.1 * m, rtol=1e-5,
                               atol=1e-6)
    step(x)
    torch.testing.assert_close(model[1]._mean, 0.19 * m, rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(model[0].weight, w0)


def test_resnet50_routes_at_full_width(resnet_flags):
    """ResNet-50 (161 parameters, 106 buffers, 25,557,032 weights) at
    224^2, batch 256, with the flags on: every one of the 16 blocks
    fuses (32 K7 launches a step each way) and 11 take K8 (layer 1's
    three, layer 2's blocks 1-3 and layer 3's blocks 1-5; the stride-2
    blocks and layer 4's 7x7 maps take a PyTorch 3x3)."""
    resnet_flags(True)
    model = resnet50(device="cpu", dtype="bfloat16")
    assert len(dict(model.named_parameters())) == 161
    assert len(dict(model.named_buffers())) == 106
    assert sum(p.numel() for p in model.parameters()) == 25557032
    model.train()
    shape, fused, k8 = [256, 56, 56, 64], [], []
    for li, layer in enumerate((model.layer1, model.layer2, model.layer3,
                                model.layer4)):
        for bi, blk in enumerate(layer):
            x = torch.empty(shape, device="meta", dtype=torch.bfloat16)
            if blk._fused_ok(x):
                fused.append((li + 1, bi))
                if blk._uses_3x3_kernel(x):
                    k8.append((li + 1, bi))
            s = blk._stride
            shape = [256, shape[1] // s, shape[2] // s,
                     blk.conv3.weight.shape[0]]
    assert len(fused) == 16
    assert k8 == [(1, 0), (1, 1), (1, 2), (2, 1), (2, 2), (2, 3), (3, 1),
                  (3, 2), (3, 3), (3, 4), (3, 5)]
