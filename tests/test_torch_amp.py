"""amp of the PyTorch port against the JAX package.

``paddle_tpu_torch.amp`` (``auto_cast`` O1/O2, ``decorate``,
``GradScaler``, ``debugging``) casts at one op-cast point
(``paddle_tpu_torch/ops/registry.py``), where the JAX package casts in
``make_op``. Checked on the same numpy-seeded inputs in both packages:

- the white and black lists, and the JAX package's amp units (O1 and O2
  dtypes, custom lists, the scaler's growth, skip on inf and
  pass-through);
- the scaler's scale and ``state_dict`` over a fixed sequence of steps
  with an injected inf;
- the tensor checker's raise and print levels, and the operator-stats
  table;
- the op table of one forward of the tiny UNet, Llama, GPT, BERT and DiT
  under O1 and O2: equal (name, dtype, calls) for every listed name
  (``flash_attention`` and ``flash_attention_ref`` counted as one) and
  for every other name a port op records. The JAX side traces its
  forward abstractly (``jax.eval_shape``: nothing compiles; the UNet's
  is traced by its training step below) with the stats hook recording
  names and dtypes, which is what the table counts;
- training: the tiny UNet through ``TrainStep`` under O1 and O2 bf16
  (one compiled JAX step per level, shared with the op table): the
  losses, every gradient of both steps and every parameter after 2
  steps; the tiny Llama eager under O1 in bf16 and fp16 with a
  ``GradScaler``: the losses and every parameter after 2 steps;
- F7: the JAX package's eager backward of ``matmul`` -> ``softmax``
  under O1 raises; the port's gradient there equals ``jax.grad`` of the
  same composition written with explicit casts.

The JAX models take their plain attention where the tests train them
(``use_flash_attention`` off): the Pallas path is held against the port
in tests/test_torch_flash_attention.py.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

import jax  # noqa: E402

import paddle_tpu as pt  # noqa: E402
from paddle_tpu import amp as jamp  # noqa: E402
from paddle_tpu import models as jmodels  # noqa: E402
from paddle_tpu import optimizer as jopt  # noqa: E402
from paddle_tpu.amp import debugging as jdebug  # noqa: E402
from paddle_tpu.framework.dtype import to_jax_dtype  # noqa: E402
from paddle_tpu.jit import TrainStep as JTrainStep  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.nn import initializer as jinit  # noqa: E402
import paddle_tpu_torch as tpt  # noqa: E402
from paddle_tpu_torch import TrainStep, amp as tamp  # noqa: E402
from paddle_tpu_torch import load_reference_state  # noqa: E402
from paddle_tpu_torch.amp import debugging as tdebug  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.nn.layer import Linear as TLinear  # noqa: E402
from paddle_tpu_torch.ops.registry import named_op  # noqa: E402
from paddle_tpu_torch.optimizer import SGD  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

# bf16 and fp16 compute on both sides, rounded at the same points but
# summed in other orders: a loss to LOSS_RTOL of itself
LOSS_RTOL = 2.0 ** -7
LEVELS = ("O1", "O2")


@contextlib.contextmanager
def _flags(**kw):
    before = pt.get_flags(list(kw))
    pt.set_flags(kw)
    try:
        yield
    finally:
        pt.set_flags(before)


@contextlib.contextmanager
def _zero_jax_init():
    """JAX initialisers return zeros, made without a compile (every
    weight is overwritten with seeded noise, or only shapes matter)."""
    def zeros(self, shape, dtype="float32"):
        return jnp.asarray(np.zeros(tuple(shape),
                                    np.dtype(to_jax_dtype(dtype))))

    with contextlib.ExitStack() as stack:
        for cls in (jinit.Constant, jinit.Normal, jinit.Uniform):
            stack.enter_context(mock.patch.object(cls, "__call__", zeros))
        yield


def _noisy(jm, seed):
    """Every JAX parameter filled with 0.1 N(0, 1), 1-D weights (norms)
    around one; returns the f32 arrays by name."""
    rng = np.random.RandomState(seed)
    for name, p in jm.named_parameters():
        noise = 0.1 * rng.randn(*p.shape).astype(np.float32)
        if name.rsplit(".", 1)[-1] == "weight" and len(p.shape) == 1:
            noise += 1.0
        p._data = jnp.asarray(noise)
    return {k: np.asarray(v._data.astype(jnp.float32))
            for k, v in jm.state_dict().items()}


def _dt(t):
    """A dtype name of either package."""
    return str(t.dtype).replace("torch.", "").replace("paddle_tpu.", "")


# ---------------------------------------------------------------------------
# the lists and the casts
# ---------------------------------------------------------------------------

def test_lists_are_the_jax_packages():
    assert tamp.amp_lists.white_list() == jamp.amp_lists.white_list()
    assert tamp.amp_lists.black_list() == jamp.amp_lists.black_list()
    assert tamp.is_bfloat16_supported() and tamp.is_float16_supported()
    for name in ("auto_cast", "amp_guard", "decorate", "GradScaler",
                 "AmpScaler", "amp_lists", "debugging",
                 "is_float16_supported", "is_bfloat16_supported"):
        assert hasattr(tpt.amp, name), name


def _cast_cases():
    """(name, JAX call, port call) over one set of numpy inputs: a white
    op, a black op, a one-input op of neither list on f32 and on bf16,
    a black loss of a bf16 and an f32 input, and a two-input op of
    neither list with one f32 input."""
    rng = np.random.RandomState(0)
    x, w = rng.randn(3, 4).astype(np.float32), rng.randn(4, 4).astype(
        np.float32)
    y = rng.randn(3, 4).astype(np.float32)
    lab = np.sign(rng.randn(3, 4)).astype(np.float32)

    def j(a, dt=None):
        t = pt.to_tensor(a)
        return t.astype(dt) if dt else t

    def t(a, dt=None):
        v = torch.from_numpy(a)
        return v.to(getattr(torch, dt)) if dt else v

    # the inputs made here, outside any auto_cast or stats collection
    jx, jw, jy, jl = j(x), j(w), j(y), j(lab)
    jxb = j(x, "bfloat16")
    tx, tw, ty, tl = t(x), t(w), t(y), t(lab)
    txb = t(x, "bfloat16")
    return [
        ("linear", lambda: JF.linear(jx, jw), lambda: TF.linear(tx, tw)),
        ("layer_norm", lambda: JF.layer_norm(jxb, 4),
         lambda: TF.layer_norm(txb, 4)),
        ("silu_f32", lambda: JF.silu(jx), lambda: TF.silu(tx)),
        ("silu_bf16", lambda: JF.silu(jxb), lambda: TF.silu(txb)),
        ("mse_loss", lambda: JF.mse_loss(jxb, jy),
         lambda: TF.mse_loss(txb, ty)),
        ("hinge_embedding_loss", lambda: JF.hinge_embedding_loss(jxb, jl),
         lambda: TF.hinge_embedding_loss(txb, tl)),
    ]


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("level", LEVELS)
def test_auto_cast_dtypes_match_jax(level, dtype):
    """Each op's output dtype and values under ``auto_cast`` equal the JAX
    package's (O1: white -> low, black -> f32, else f32 when an input is
    f32; O2: black -> f32, else low); outside the context nothing is
    cast."""
    for name, jcall, tcall in _cast_cases():
        with jamp.auto_cast(level=level, dtype=dtype):
            want = jcall()
        with tamp.auto_cast(level=level, dtype=dtype):
            got = tcall()
        assert _dt(got) == _dt(want), (name, _dt(got), _dt(want))
        w32 = np.asarray(want._data.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), w32, rtol=2.0 ** -7,
                                   atol=2.0 ** -7 * float(np.abs(w32).max()),
                                   err_msg=name)
    assert _dt(_cast_cases()[0][2]()) == "float32"


def test_custom_lists_match_jax():
    """A custom black-list name leaves the white list and a custom
    white-list name the black list, in both packages."""
    (_, jlin, tlin), (_, jln, tln) = _cast_cases()[:2]
    with jamp.auto_cast(custom_black_list={"linear"}):
        jl = jlin()
    with tamp.auto_cast(custom_black_list={"linear"}):
        tl = tlin()
    with jamp.auto_cast(custom_white_list={"layer_norm"}):
        jn = jln()
    with tamp.auto_cast(custom_white_list={"layer_norm"}):
        tn = tln()
    assert (_dt(tl), _dt(tn)) == (_dt(jl), _dt(jn)) == ("float32",
                                                          "bfloat16")


def _linears():
    """A 2 -> 2 linear without bias in both packages, same weights."""
    jm = pt.nn.Linear(2, 2, bias_attr=False)
    w = np.array([[0.5, -1.0], [2.0, 0.25]], np.float32)
    jm.weight._data = jnp.asarray(w)
    tm = TLinear(2, 2, bias_attr=False, device="cpu")
    with torch.no_grad():
        tm.weight.copy_(torch.from_numpy(w))
    return jm, tm


def test_grad_scaler_dynamic_matches_jax():
    """The JAX unit: a good step at ``incr_every_n_steps=1`` doubles the
    scale; the scaled loss and the stepped weights agree."""
    jm, tm = _linears()
    js = jamp.GradScaler(init_loss_scaling=4.0, incr_every_n_steps=1)
    ts = tamp.GradScaler(init_loss_scaling=4.0, incr_every_n_steps=1)
    jopt_ = jopt.SGD(0.1, parameters=jm.parameters())
    topt = SGD(0.1, parameters=tm.parameters())
    jl = js.scale(jm(pt.ones([1, 2])).sum())
    tl = ts.scale(tm(torch.ones(1, 2)).sum())
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-6)
    jl.backward()
    tl.backward()
    for s, o in ((js, jopt_), (ts, topt)):
        s.step(o)
        s.update()
    assert ts._scale == js._scale == 8.0
    np.testing.assert_allclose(tm.weight.detach().numpy(), jm.weight.numpy(),
                               rtol=1e-6)


def test_grad_scaler_skips_on_inf_matches_jax():
    """The JAX unit: an inf gradient skips the step (weights unchanged)
    and halves the scale."""
    jm, tm = _linears()
    before = jm.weight.numpy().copy()
    js, ts = (m.GradScaler(init_loss_scaling=4.0) for m in (jamp, tamp))
    jopt_ = jopt.SGD(0.1, parameters=jm.parameters())
    topt = SGD(0.1, parameters=tm.parameters())
    jm(pt.ones([1, 2])).sum().backward()
    tm(torch.ones(1, 2)).sum().backward()
    jm.weight.grad._data = jm.weight.grad.data * np.inf
    with torch.no_grad():
        tm.weight.grad.mul_(float("inf"))
    for s, o in ((js, jopt_), (ts, topt)):
        s.step(o)
        s.update()
    np.testing.assert_array_equal(tm.weight.detach().numpy(), before)
    np.testing.assert_array_equal(jm.weight.numpy(), before)
    assert ts._scale == js._scale == 2.0


def test_scaler_disabled_passthrough_matches_jax():
    """``enable=False``: ``scale`` returns its input, ``step`` steps."""
    js, ts = (m.GradScaler(enable=False) for m in (jamp, tamp))
    x = torch.tensor([1.0])
    assert ts.scale(x) is x
    jx = pt.to_tensor([1.0])
    assert js.scale(jx) is jx
    jm, tm = _linears()
    topt = SGD(0.1, parameters=tm.parameters())
    tm(torch.ones(1, 2)).sum().backward()
    ts.step(topt)
    ts.update()
    assert not np.array_equal(tm.weight.detach().numpy(), jm.weight.numpy())
    assert not ts.is_enable() and ts._scale == js._scale


def test_scaler_history_and_state_dict_match_jax():
    """Six steps of ``scale``/``backward``/``step``/``update`` (scale 8,
    grow every 2 good steps, shrink on each bad one) with an inf injected
    at step 3: after each step the scale, ``get_loss_scaling`` (an f32
    tensor), the ``state_dict`` and the weights equal the JAX package's;
    a new scaler loaded from the last ``state_dict`` carries it on."""
    jm, tm = _linears()
    kw = dict(init_loss_scaling=8.0, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=1)
    js, ts = jamp.GradScaler(**kw), tamp.GradScaler(**kw)
    jopt_ = jopt.SGD(0.05, parameters=jm.parameters())
    topt = SGD(0.05, parameters=tm.parameters())
    history = []
    for i in range(6):
        js.scale((jm(pt.ones([1, 2])) ** 2).sum()).backward()
        ts.scale((tm(torch.ones(1, 2)) ** 2).sum()).backward()
        if i == 3:
            jm.weight.grad._data = jm.weight.grad.data * np.inf
            with torch.no_grad():
                tm.weight.grad.mul_(float("inf"))
        for s, o in ((js, jopt_), (ts, topt)):
            s.step(o)
            s.update()
            o.clear_grad()
        got, want = ts.get_loss_scaling(), js.get_loss_scaling()
        assert got.dtype == torch.float32 and float(got) == float(want)
        assert ts.state_dict() == js.state_dict(), i
        np.testing.assert_allclose(tm.weight.detach().numpy(),
                                   jm.weight.numpy(), rtol=1e-6)
        history.append(ts._scale)
    assert history == [8.0, 16.0, 16.0, 8.0, 8.0, 16.0]
    js2, ts2 = jamp.GradScaler(), tamp.GradScaler()
    js2.load_state_dict(js.state_dict())
    ts2.load_state_dict(ts.state_dict())
    assert ts2.state_dict() == js2.state_dict() == js.state_dict()


# ---------------------------------------------------------------------------
# debugging
# ---------------------------------------------------------------------------

def _inf_linear():
    x = np.array([[1.0, np.inf]], np.float32)
    w = np.ones((2, 2), np.float32)
    jx, jw = pt.to_tensor(x), pt.to_tensor(w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    return lambda: JF.linear(jx, jw), lambda: TF.linear(tx, tw)


@pytest.mark.parametrize("mode", ["CHECK_NAN_INF_AND_ABORT", "CHECK_ALL"])
def test_tensor_checker_matches_jax(mode, capsys):
    """The tensor checker (the ``check_nan_inf`` flags): level 0 raises
    ``FloatingPointError`` naming the op, level 3 prints a warning, in
    both packages alike; disabled, nothing happens."""
    jcall, tcall = _inf_linear()
    for pkg, dbg, call in ((pt, jdebug, jcall), (tpt, tdebug, tcall)):
        cfg = dbg.TensorCheckerConfig(
            enable=True, debug_mode=getattr(dbg.DebugMode, mode))
        dbg.enable_tensor_checker(cfg)
        try:
            if mode == "CHECK_NAN_INF_AND_ABORT":
                with pytest.raises(FloatingPointError,
                                   match="op 'linear' produced nan/inf"):
                    call()
            else:
                call()
        finally:
            dbg.disable_tensor_checker()
        call()
    out = capsys.readouterr().out.splitlines()
    if mode == "CHECK_ALL":
        assert out == ["WARNING: op 'linear' produced nan/inf"] * 2
    else:
        assert out == []
    assert tpt.flags.flag_value("check_nan_inf") is False


def test_operator_stats_table_matches_jax(capsys):
    """``collect_operator_stats`` over the same ops prints the same table
    and returns the same stats (op, dtype, nan and inf counts, max and
    min) in both packages; ``compare_accuracy`` raises in both."""
    jinf, tinf = _inf_linear()
    cases = _cast_cases()
    with jdebug.collect_operator_stats():
        with jamp.auto_cast(level="O1"):
            for _, jcall, _ in cases:
                jcall()
        jinf()
    jtable = capsys.readouterr().out
    with tdebug.collect_operator_stats():
        with tamp.auto_cast(level="O1"):
            for _, _, tcall in cases:
                tcall()
        tinf()
    ttable = capsys.readouterr().out
    assert ttable == jtable
    assert "linear                          bfloat16    1" in ttable
    for dbg in (jdebug, tdebug):
        dbg.enable_operator_stats_collection()
        with tamp.auto_cast(), jamp.auto_cast():
            cases[0][1]()
            cases[0][2]()
        stats = dbg.disable_operator_stats_collection()
        assert [(s["op"], s["dtype"]) for s in stats] == [
            ("linear", "bfloat16")]
    jstats, tstats = [], []
    for dbg, call, out in ((jdebug, jinf, jstats), (tdebug, tinf, tstats)):
        dbg.enable_operator_stats_collection()
        call()
        out += dbg.disable_operator_stats_collection()
    assert [{k: s[k] for k in ("op", "dtype", "num_nan", "num_inf")}
            for s in tstats] == [{k: s[k] for k in ("op", "dtype", "num_nan",
                                                    "num_inf")}
                                 for s in jstats]
    for k in ("max", "min"):
        assert tstats[0][k] == jstats[0][k]
    capsys.readouterr()
    for dbg in (jdebug, tdebug):
        with pytest.raises(NotImplementedError):
            dbg.compare_accuracy("a", "b", "c")


# ---------------------------------------------------------------------------
# the op table of five models
# ---------------------------------------------------------------------------

def _tokens(seed, b=2, s=16, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int64)


# family -> (JAX model, port model, numpy inputs, JAX call, port call)
def _family(name):
    ids, labels = _tokens(1), _tokens(2)
    if name == "dit":
        rng = np.random.RandomState(4)
        x = rng.randn(2, 4, 8, 8).astype(np.float32)
        t, y = np.array([3, 500]), np.array([1, 2])
        return (lambda: jmodels.DiT(jmodels.DiTConfig.tiny()),
                lambda: tpt.DiT(tpt.DiTConfig.tiny(), device="cpu"),
                (x, t.astype(np.int32), y.astype(np.int32)), (x, t, y))
    jcls, tcls = {"llama": ("LlamaForCausalLM", "LlamaConfig"),
                  "gpt": ("GPTForCausalLM", "GPTConfig"),
                  "bert": ("BertForPretraining", "BertConfig")}[name]
    return (lambda: getattr(jmodels, jcls)(getattr(jmodels, tcls).tiny()),
            lambda: getattr(tpt, jcls)(getattr(tpt, tcls).tiny(),
                                       device="cpu"),
            (ids.astype(np.int32), labels.astype(np.int32)), (ids, labels))


def _jax_table(name, level):
    """(name, dtype) -> calls of one JAX forward under ``level``, by the
    operator-stats hook's keys, traced abstractly (nothing compiles)."""
    make, _, jin, _ = _family(name)
    with _zero_jax_init():
        jm = make()
    if level == "O2":
        jamp.decorate(jm, level="O2")
    rec = []

    def hook(op, arrays):
        rec.extend((op, str(a.dtype)) for a in arrays
                   if jnp.issubdtype(a.dtype, jnp.inexact))

    def forward(*arrays):
        ts = [pt.to_tensor(a) for a in arrays]
        with pt.no_grad():      # no VJP traced, as the port's side
            if name in ("llama", "gpt", "bert"):
                jm(ts[0], labels=ts[1])
            else:
                jm(*ts)
        return 0

    with mock.patch.object(jdebug, "_op_stats_hook", hook), \
            contextlib.redirect_stdout(None):
        with jdebug.collect_operator_stats(), jamp.auto_cast(level=level):
            jax.eval_shape(forward, *jin)
    return _count(rec)


def _port_table(name, level):
    _, make, _, tin = _family(name)
    tm = make()
    if level == "O2":
        tamp.decorate(tm, level="O2")
    ts = [torch.from_numpy(a) for a in tin]
    with contextlib.redirect_stdout(None):
        tdebug.enable_operator_stats_collection()
        with torch.no_grad(), tamp.auto_cast(level=level):
            if name in ("llama", "gpt", "bert"):
                tm(ts[0], labels=ts[1])
            else:
                tm(*ts)
        stats = tdebug.disable_operator_stats_collection()
    return _count([(s["op"], s["dtype"]) for s in stats])


def _count(rec):
    table = {}
    for op, dt in rec:
        key = ("flash_attention" if op == "flash_attention_ref" else op, dt)
        table[key] = table.get(key, 0) + 1
    return table


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("family", ["unet", "llama", "gpt", "bert", "dit"])
def test_op_table_matches_jax(unet_runs, family, level):
    """One forward under ``auto_cast``: every listed name and every name
    the port records has the same (name, dtype, calls) as in the JAX
    package. The decoders' projections are raw products in both, outside
    amp (F8): only attention, the norms, the losses and Llama's head
    product are cast. The UNet's forward is its first training step's
    (with ``sd_loss_fn``), recorded by the training test's runs."""
    if family == "unet":
        _, want, got = unet_runs(level)
        want, got = want["table"], got["table"]
    else:
        want, got = _jax_table(family, level), _port_table(family, level)
    listed = tamp.amp_lists.white_list() | tamp.amp_lists.black_list()
    keys = {k for k in want if k[0] in listed} | set(got)
    assert {k: got.get(k) for k in keys} == {k: want.get(k) for k in keys}
    assert any(k[0] == "flash_attention" for k in got)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

# the tiny UNet trained 2 SGD steps (f32 masters) at UNET_LR: each
# gradient of each step to GRAD_REL of its L2 norm (bf16 products summed
# in other orders; the worst tensor reads 0.044, O2's first step), and
# each weight after the steps to MOVE_REL of the largest move of its
# tensor (the worst reads 0.11). A zero, sign-flipped or unrelated
# gradient is off by 1 or more of its norm and of the move.
UNET_LR = 0.05
GRAD_REL = 2.0 ** -3
MOVE_REL = 2.0 ** -2


def _unet_batch():
    rng = np.random.RandomState(5)
    return (rng.randn(2, 4, 16, 16).astype(np.float32),
            np.array([17, 901], np.int64),
            rng.randn(2, 7, 32).astype(np.float32),
            rng.randn(2, 4, 16, 16).astype(np.float32))


def _committed(a):
    return jax.device_put(jnp.asarray(a), jax.devices()[0])


def _jax_unet_run(start, level):
    """The JAX side: the tiny UNet from ``start`` (O2 after ``decorate``)
    trained 2 SGD steps by one compiled ``paddle_tpu.jit.TrainStep`` under
    ``auto_cast(level)``: the op table of the first step's forward
    (recorded while the step is traced), the losses, every gradient of
    each step (copied out of ``grad_postprocess``, in the masters' f32),
    the parameters' dtypes and the weights after (the f32 masters)."""
    with _zero_jax_init():
        jm = jmodels.UNet2DConditionModel(
            jmodels.UNetConfig.tiny(attention_head_dim=8))
    for n, p in jm.named_parameters():
        p._data = jnp.asarray(start[n])
    if level == "O2":
        jamp.decorate(jm, level="O2")
    for _, p in jm.named_parameters():
        p._data = _committed(p._data)
    rec, grads = [], []

    def hook(op, arrays):
        rec.extend((op, str(a.dtype)) for a in arrays
                   if jnp.issubdtype(a.dtype, jnp.inexact))

    def capture(g):
        jax.debug.callback(lambda host: grads.append(
            {n: np.asarray(a, np.float32) for n, a in host.items()}), g)
        return g

    with _flags(use_flash_attention=False), jamp.auto_cast(level=level):
        step = JTrainStep(jm, jopt.SGD(UNET_LR, parameters=jm.parameters()),
                          jmodels.sd_loss_fn, grad_postprocess=capture,
                          multi_precision=True)
        step._init_state()
        step._state = jax.device_put(step._state, jax.devices()[0])
        batch = [pt.to_tensor(_committed(a)) for a in _unet_batch()]
        with mock.patch.object(jdebug, "_op_stats_hook", hook), \
                contextlib.redirect_stdout(None), \
                jdebug.collect_operator_stats():
            losses = [float(step(*batch))]
        losses.append(float(step(*batch)))
    masters = step._state["master"]
    return dict(table=_count(rec), losses=losses, grads=grads,
                dtypes={n: str(p._data.dtype)
                        for n, p in jm.named_parameters()},
                weights={n: np.asarray(masters.get(n, p._data), np.float32)
                         for n, p in jm.named_parameters()})


def _port_unet_run(start, level):
    """The port's side, as :func:`_jax_unet_run`: its op table recorded
    over the first step, which runs the forward once."""
    tm = tpt.UNet2DConditionModel(tpt.UNetConfig.tiny(attention_head_dim=8),
                                  device="cpu")
    load_reference_state(tm, start)
    if level == "O2":
        tamp.decorate(tm, level="O2")
    grads = []

    def capture(g):
        grads.append({n: v.float().numpy().copy() for n, v in g.items()})
        return g

    step = TrainStep(tm, SGD(UNET_LR), tpt.sd_loss_fn,
                     grad_postprocess=capture, multi_precision=True)
    batch = [torch.from_numpy(a) for a in _unet_batch()]
    with tamp.auto_cast(level=level):
        with contextlib.redirect_stdout(None):
            tdebug.enable_operator_stats_collection()
            losses = [float(step(*batch))]
            stats = tdebug.disable_operator_stats_collection()
        losses.append(float(step(*batch)))
    return dict(table=_count([(s["op"], s["dtype"]) for s in stats]),
                losses=losses, grads=grads,
                dtypes={n: _dt(p) for n, p in tm.named_parameters()},
                weights={n: step._work(n, p).float().numpy()
                         for n, p in tm.named_parameters()})


@pytest.fixture(scope="module")
def unet_runs():
    """level -> (JAX run, port run) of the tiny UNet, each made once and
    shared by the op table and the training test."""
    with _zero_jax_init():
        jm = jmodels.UNet2DConditionModel(
            jmodels.UNetConfig.tiny(attention_head_dim=8))
    start = _noisy(jm, 7)
    runs = {}

    def run(level):
        if level not in runs:
            runs[level] = (start, _jax_unet_run(start, level),
                           _port_unet_run(start, level))
        return runs[level]

    return run


@pytest.mark.parametrize("level", LEVELS)
def test_unet_trainstep_under_auto_cast_matches_jax(unet_runs, level):
    """The tiny UNet (heads of 8) trained 2 SGD steps (f32 masters)
    through ``TrainStep`` under ``auto_cast(level)`` in bf16, O2 after
    ``decorate``, against one compiled JAX step: the losses to
    LOSS_RTOL, every gradient of both steps to GRAD_REL and every weight
    after the steps to MOVE_REL of its tensor's largest move. Under O2
    the f32 timestep embedding meets the bf16 weights at the next op,
    cast there (F5 does not arise)."""
    start, want, got = unet_runs(level)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    assert got["dtypes"] == want["dtypes"]
    assert len(got["grads"]) == len(want["grads"]) == 2
    for i, (g, jg) in enumerate(zip(got["grads"], want["grads"])):
        assert set(g) == set(jg)
        for n, w in jg.items():
            err = float(np.linalg.norm(g[n] - w))
            assert err <= GRAD_REL * float(np.linalg.norm(w)), (i, n, err)
    for n, jw in want["weights"].items():
        move = float(np.abs(jw - start[n]).max())
        err = float(np.abs(got["weights"][n] - jw).max())
        assert 0 < move and err <= MOVE_REL * move, (n, err, move)


@pytest.fixture(scope="module")
def llama_start():
    with _zero_jax_init():
        jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(
            max_position_embeddings=256))
    return _noisy(jm, 8)


LLAMA_LR = 0.5


@pytest.fixture(scope="module")
def jax_llama_eager_grads(llama_start):
    """The JAX package's eager backward of the tiny Llama under O1 with
    its ``GradScaler``: the parameters it reaches (F9: the decoder's
    arrays are raw, so the tape holds only the final norm and the head)."""
    with _zero_jax_init():
        jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(
            max_position_embeddings=256, fused_head_loss=True))
    for n, p in jm.named_parameters():
        p._data = jnp.asarray(llama_start[n])
    ids = pt.to_tensor(_tokens(9, s=32).astype(np.int32))
    with _flags(use_flash_attention=False), jamp.auto_cast(level="O1"):
        _, loss = jm(ids, labels=ids)
    jamp.GradScaler(init_loss_scaling=1024.0).scale(loss).backward()
    return {n for n, p in jm.named_parameters() if p.grad is not None}


def test_f9_jax_eager_llama_backward_reaches_only_the_head(
        jax_llama_eager_grads):
    """F9: the JAX package's eager backward of Llama reaches only the
    final norm and the LM head (its layers compute on raw arrays, so its
    training goes through ``TrainStep``); the port's eager backward
    reaches every parameter (the next test)."""
    assert jax_llama_eager_grads == {"llama.norm.weight", "lm_head.weight"}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_llama_eager_o1_with_grad_scaler_matches_jax(llama_start, dtype):
    """The tiny Llama eager under ``auto_cast(level="O1", dtype)`` with a
    ``GradScaler`` (1024, growing every good step) and SGD, 2 steps: each
    loss to LOSS_RTOL and every weight after the steps against one
    compiled JAX ``TrainStep`` with the same SGD under the same
    ``auto_cast`` (the JAX package's eager backward does not reach the
    decoder, F9; a finite power-of-two scale leaves the gradients as
    they are). A weight to 2^-5 of the largest move of its tensor: the
    16-bit attention's and head's gradients agree to a few ulps, the
    projections are f32 (F8). The scale grows to 4096."""
    tm = tpt.LlamaForCausalLM(tpt.LlamaConfig.tiny(
        max_position_embeddings=256), device="cpu")
    load_reference_state(tm, llama_start)
    ids, labels = _tokens(9, s=32), _tokens(10, s=32)
    topt = SGD(LLAMA_LR, parameters=tm.parameters())
    scaler = tamp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=1)
    got = []
    for _ in range(2):
        with tamp.auto_cast(level="O1", dtype=dtype):
            _, loss = tm(torch.from_numpy(ids),
                         labels=torch.from_numpy(labels))
        scaler.scale(loss).backward()
        scaler.step(topt)
        scaler.update()
        topt.clear_grad()
        got.append(float(loss.detach()))
    assert scaler._scale == 4096.0
    with _zero_jax_init():
        jm = jmodels.LlamaForCausalLM(jmodels.LlamaConfig.tiny(
            max_position_embeddings=256))
    for n, p in jm.named_parameters():
        p._data = _committed(llama_start[n])
    with _flags(use_flash_attention=False), \
            jamp.auto_cast(level="O1", dtype=dtype):
        step = JTrainStep(jm, jopt.SGD(LLAMA_LR, parameters=jm.parameters()),
                          jmodels.llama_loss_fn)
        jb = [pt.to_tensor(_committed(a.astype(np.int32)))
              for a in (ids, labels)]
        want = [float(step(*jb)) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    for n, p in tm.named_parameters():
        w, w0 = p.detach().numpy(), llama_start[n]
        jw = np.asarray(jm.state_dict()[n]._data)
        move = max(float(np.abs(jw - w0).max()), 1e-12)
        assert float(np.abs(w - jw).max()) <= 2.0 ** -5 * move, (
            n, float(np.abs(w - jw).max()), move)


# ---------------------------------------------------------------------------
# F7: the JAX package's eager backward across a cast
# ---------------------------------------------------------------------------

_softmax = named_op("softmax")(lambda z: torch.softmax(z, dim=-1))
_matmul = named_op("matmul")(torch.matmul)


def test_f7_jax_eager_backward_raises_port_matches_explicit_casts():
    """Under O1 the JAX package's eager backward of ``matmul`` (white,
    bf16) -> ``softmax`` (black, f32) raises: ``make_op`` casts the raw
    arrays outside the VJP, so an f32 cotangent reaches the bf16 matmul's
    VJP (F7, queue 3). The port casts with ``Tensor.to``, which autograd
    differentiates: its gradients equal ``jax.grad`` of the same
    composition written with explicit ``astype``."""
    rng = np.random.RandomState(11)
    x, y = rng.randn(4, 8).astype(np.float32), rng.randn(8, 8).astype(
        np.float32)
    c = rng.randn(4, 8).astype(np.float32)
    jx, jy = pt.to_tensor(x), pt.to_tensor(y)
    jx.stop_gradient = jy.stop_gradient = False
    with jamp.auto_cast(level="O1"):
        s = JF.softmax(pt.matmul(jx, jy))
    with pytest.raises((ValueError, TypeError)):
        (s * pt.to_tensor(c)).sum().backward()

    def explicit(x, y):
        z = jnp.matmul(x.astype(jnp.bfloat16), y.astype(jnp.bfloat16))
        return jnp.sum(jax.nn.softmax(z.astype(jnp.float32), axis=-1) * c)

    wx, wy = jax.grad(explicit, argnums=(0, 1))(x, y)
    tx, ty = (torch.from_numpy(a).requires_grad_() for a in (x, y))
    with tamp.auto_cast(level="O1"):
        ts = _softmax(_matmul(tx, ty))
    assert ts.dtype == torch.float32
    (ts * torch.from_numpy(c)).sum().backward()
    for g, w in ((tx.grad, wx), (ty.grad, wy)):
        assert g.dtype == torch.float32
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=2.0 ** -7 * float(np.abs(w).max()))
