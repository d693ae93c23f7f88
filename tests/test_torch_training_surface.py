"""The port's training surface against the JAX package: learning-rate
schedulers, the optimizers and their eager path, the loss functions and
layers, per-layer recompute, and ``TrainStep``'s ``grad_postprocess``,
``return_outputs`` and schedule.

- The 17 schedulers give the reference's learning rates float for float
  over 30 steps, across a ``state_dict`` round trip at step 10.
- Each optimizer's in-place ``_update`` equals the JAX package's pure
  one over three f32 updates (1e-6: one rounding order apart); the eager
  ``step()`` (f32, and bf16 parameters with f32 masters) equals the JAX
  eager step, with the reference's state-dict keys.
- Every loss function and layer, with each reduction and option, equals
  the reference's (f32: 1e-6 absolute, 1e-5 relative).
- A tiny Llama under each recompute granularity gives the loss and every
  gradient of the port without recompute exactly (the CPU reruns the
  same operations), and of the JAX package with recompute on to 1e-5.
  The JAX package recomputes only under ``to_static`` tracing, so its
  functional step runs the layer as it is under every policy: one JAX
  run with ``recompute=True`` is the reference for the three.
- A 3-step ``TrainStep`` with ``LinearWarmup`` over
  ``CosineAnnealingDecay``, ``grad_postprocess`` and ``return_outputs``
  equals ``paddle_tpu.jit.TrainStep`` (losses, outputs, weights).
- The reference's ignored options (ROADMAP queue 3, F4) are pinned in
  both packages: ``AdamW(lr_ratio=...)``, parameter-group dicts and
  ``TrainStep(remat=...)`` leave the trajectory as it is without them.

Everything runs on the CPU. The ``TrainStep`` cases use a two-layer MLP,
whose JAX steps compile in a fraction of a second.
"""

import copy

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
from paddle_tpu.models import LlamaConfig as JLlamaConfig  # noqa: E402
from paddle_tpu.models import \
    LlamaForCausalLM as JLlamaForCausalLM  # noqa: E402
from paddle_tpu.nn import functional as JF  # noqa: E402
from paddle_tpu.optimizer import lr as jlr  # noqa: E402
from paddle_tpu_torch import (LlamaConfig, LlamaForCausalLM,  # noqa: E402
                              TrainStep, llama_loss_fn, load_reference_state)
from paddle_tpu_torch import nn as tnn  # noqa: E402
from paddle_tpu_torch import optimizer as topt  # noqa: E402
from paddle_tpu_torch.nn import functional as TF  # noqa: E402
from paddle_tpu_torch.optimizer import lr as tlr  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402, F401

# f32 loss values: other implementations of log, exp and the sums
LOSS_ATOL, LOSS_RTOL = 1e-6, 1e-5


# -- learning-rate schedulers -------------------------------------------------

def _decay(e):
    return 0.97 ** e


SCHEDULERS = {
    "NoamDecay": lambda lr: lr.NoamDecay(64, 5, learning_rate=1.0),
    "PiecewiseDecay": lambda lr: lr.PiecewiseDecay(
        [5, 12, 20], [0.1, 0.05, 0.01, 0.001]),
    "NaturalExpDecay": lambda lr: lr.NaturalExpDecay(0.5, gamma=0.1),
    "InverseTimeDecay": lambda lr: lr.InverseTimeDecay(0.5, gamma=0.2),
    "PolynomialDecay": lambda lr: lr.PolynomialDecay(
        0.5, decay_steps=12, end_lr=0.01, power=2.0),
    "PolynomialDecay_cycle": lambda lr: lr.PolynomialDecay(
        0.5, decay_steps=7, cycle=True),
    "LinearWarmup_float": lambda lr: lr.LinearWarmup(
        0.3, warmup_steps=6, start_lr=0.0, end_lr=0.3),
    "LinearWarmup_cosine": lambda lr: lr.LinearWarmup(
        lr.CosineAnnealingDecay(0.3, T_max=20), warmup_steps=6,
        start_lr=0.01, end_lr=0.3),
    "ExponentialDecay": lambda lr: lr.ExponentialDecay(0.5, gamma=0.9),
    "MultiStepDecay": lambda lr: lr.MultiStepDecay(
        0.5, milestones=[4, 9, 17], gamma=0.5),
    "StepDecay": lambda lr: lr.StepDecay(0.5, step_size=7, gamma=0.3),
    "LambdaDecay": lambda lr: lr.LambdaDecay(0.5, lr_lambda=_decay),
    "CosineAnnealingDecay": lambda lr: lr.CosineAnnealingDecay(
        0.5, T_max=13, eta_min=0.01),
    "CosineAnnealingWarmRestarts": lambda lr: lr.CosineAnnealingWarmRestarts(
        0.5, T_0=5, T_mult=2, eta_min=0.001),
    "OneCycleLR_cos": lambda lr: lr.OneCycleLR(0.5, total_steps=25),
    "OneCycleLR_linear": lambda lr: lr.OneCycleLR(
        0.5, total_steps=25, anneal_strategy="linear", phase_pct=0.4),
    "CyclicLR_triangular2": lambda lr: lr.CyclicLR(
        0.01, 0.3, step_size_up=4, step_size_down=6, mode="triangular2"),
    "CyclicLR_exp_range": lambda lr: lr.CyclicLR(
        0.01, 0.3, step_size_up=5, mode="exp_range", exp_gamma=0.98),
    "MultiplicativeDecay": lambda lr: lr.MultiplicativeDecay(
        0.5, lr_lambda=lambda e: 0.9),
    "LinearLR": lambda lr: lr.LinearLR(0.5, total_steps=10, start_factor=0.2),
    "ReduceOnPlateau_rel_min": lambda lr: lr.ReduceOnPlateau(
        0.5, patience=2, factor=0.5, cooldown=1),
    "ReduceOnPlateau_abs_max": lambda lr: lr.ReduceOnPlateau(
        0.5, mode="max", threshold=0.05, threshold_mode="abs", patience=1,
        min_lr=0.05),
}
# ReduceOnPlateau's metric: falls, stalls, falls, stalls
METRICS = [1.0 - 0.02 * min(i, 5) - 0.02 * max(0, min(i, 18) - 12)
           for i in range(30)]


def _lr_sequence(make, lr_module, steps=30, round_trip_at=10):
    sched = make(lr_module)
    plateau = isinstance(sched, lr_module.ReduceOnPlateau)
    out = []
    for i in range(steps):
        if i == round_trip_at:
            fresh = make(lr_module)
            fresh.set_state_dict(copy.deepcopy(sched.state_dict()))
            sched = fresh
        out.append(sched())
        sched.step(METRICS[i]) if plateau else sched.step()
    return out


def test_every_scheduler_is_covered():
    names = {n for n in dir(jlr) if isinstance(getattr(jlr, n), type)
             and issubclass(getattr(jlr, n), jlr.LRScheduler)}
    assert len(names - {"LRScheduler"}) == 17
    assert {k.split("_")[0] for k in SCHEDULERS} == names - {"LRScheduler"}
    assert all(hasattr(tlr, n) for n in names)


@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_scheduler_matches_jax(case):
    """30 steps, a state_dict round trip into a new scheduler at step 10:
    the same rates, float for float."""
    want = _lr_sequence(SCHEDULERS[case], jlr)
    got = _lr_sequence(SCHEDULERS[case], tlr)
    assert got == want
    assert len(set(got)) > 1


def test_optimizer_reads_the_scheduler():
    """``get_lr()`` reads the scheduler, ``set_lr`` refuses under one, and
    the optimizer's state dict carries the scheduler's."""
    sched = tlr.StepDecay(0.5, step_size=2)
    opt = topt.SGD(learning_rate=sched)
    jopt_ = jopt.SGD(learning_rate=jlr.StepDecay(0.5, step_size=2))
    for _ in range(4):
        assert opt.get_lr() == jopt_.get_lr()
        sched.step()
        jopt_._learning_rate.step()
    with pytest.raises(RuntimeError):
        opt.set_lr(0.1)
    assert opt.state_dict()["LR_Scheduler"] == sched.state_dict()


# -- optimizers ---------------------------------------------------------------

OPT_CASES = {
    "SGD_decay": ("SGD", dict(weight_decay=0.1)),
    "Adamax": ("Adamax", dict(beta1=0.8)),
    "Lamb": ("Lamb", dict(lamb_weight_decay=0.05)),
    "Adagrad": ("Adagrad", dict(initial_accumulator_value=0.1,
                                weight_decay=0.01)),
    "RMSProp_momentum": ("RMSProp", dict(momentum=0.5)),
    "RMSProp_centered": ("RMSProp", dict(centered=True, momentum=0.9)),
    "Adadelta": ("Adadelta", dict(weight_decay=0.1)),
    "ASGD": ("ASGD", dict(batch_num=2)),
    "Rprop": ("Rprop", dict()),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_update_matches_jax(case):
    """Three f32 updates of one weight: the port's in-place ``_update``
    equals the JAX package's pure one to 1e-6, weights and slots."""
    name, kw = OPT_CASES[case]
    rng = np.random.RandomState(8)
    w = rng.randn(8, 16).astype(np.float32)
    grads = [rng.randn(8, 16).astype(np.float32) for _ in range(3)]
    kw = dict(learning_rate=1e-2, **kw)
    jo = getattr(jopt, name)(parameters=[], **kw)
    to = getattr(topt, name)(**kw)
    jw, tw = jnp.asarray(w), torch.from_numpy(w.copy())
    js, ts = jo._init_slots(jw), to._init_slots(tw)
    assert set(js) == set(ts)
    for step, g in enumerate(grads, 1):
        jw, js = jo._update(jw, jnp.asarray(g), js, 1e-2, step)
        to._update(tw, torch.from_numpy(g), ts, 1e-2, step)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   atol=1e-6, rtol=1e-6, err_msg=k)


def test_lamb_exclusion_takes_the_parameter():
    """``exclude_from_weight_decay_fn`` gets the parameter in both
    packages (the port's ``_param_wd`` takes its name and the parameter)."""
    fn = lambda p: len(p.shape) == 1  # noqa: E731
    lin = jnn.Linear(4, 3)
    jo = jopt.Lamb(lamb_weight_decay=0.05, exclude_from_weight_decay_fn=fn)
    to = topt.Lamb(lamb_weight_decay=0.05, exclude_from_weight_decay_fn=fn)
    assert jo._param_wd(lin.bias) == to._param_wd("b", torch.zeros(3)) == 0
    assert jo._param_wd(lin.weight) == to._param_wd(
        "w", torch.zeros(4, 3)) == 0.05


EAGER_CASES = {
    "AdamW_f32_clip": ("AdamW", "float32", dict(weight_decay=0.1)),
    "Momentum_bf16_masters": ("Momentum", "bfloat16", dict(momentum=0.8)),
    "Lamb_f32": ("Lamb", "float32", dict()),
}


@pytest.mark.parametrize("case", sorted(EAGER_CASES))
def test_eager_step_and_state_dict_match_jax(case):
    """Two eager ``step()`` calls on a Linear layer's parameters with the
    same gradients: the same weights (f32 masters where the parameters are
    bf16), the reference's state-dict keys and values, and a
    ``set_state_dict`` round trip that steps on alike."""
    name, dtype, kw = EAGER_CASES[case]
    rng = np.random.RandomState(9)
    lin = jnn.Linear(4, 3)
    jparams = [lin.weight, lin.bias]
    tparams = []
    for p in jparams:
        a = rng.randn(*p.shape).astype(np.float32)
        p._data = jnp.asarray(a).astype(dtype)
        tparams.append(torch.nn.Parameter(
            torch.from_numpy(a).to(getattr(torch, dtype))))
    kw = dict(learning_rate=1e-2, **kw)
    clip = case.endswith("clip")
    jo = getattr(jopt, name)(parameters=jparams, grad_clip=(
        jnn.ClipGradByGlobalNorm(0.5) if clip else None), **kw)
    to = getattr(topt, name)(parameters=tparams, grad_clip=(
        tnn.clip.ClipGradByGlobalNorm(0.5) if clip else None), **kw)
    grads = [[rng.randn(*p.shape).astype(np.float32) for p in jparams]
             for _ in range(3)]

    def step(i, jo, to):
        for jp, tp, g in zip(jparams, tparams, grads[i]):
            jp.grad = pt.to_tensor(jnp.asarray(g).astype(dtype))
            tp.grad = torch.from_numpy(g).to(tp.dtype)
        jo.step()
        to.step()

    step(0, jo, to)
    step(1, jo, to)
    tol = 1e-6 if dtype == "float32" else 1e-2
    for jp, tp in zip(jparams, tparams):
        np.testing.assert_allclose(tp.detach().float().numpy(),
                                   np.asarray(jp._data.astype(jnp.float32)),
                                   atol=tol, rtol=tol)
    jsd, tsd = jo.state_dict(), to.state_dict()
    # the reference's keys: "<name>.<slot>"; the port names a parameter by
    # its place in the list, as the reference does a parameter without a
    # name
    rename = {p.name: f"param_{i}" for i, p in enumerate(jparams)}
    assert tsd["step"] == jsd["step"] == 2
    assert set(tsd) == {k if k == "step" else
                        "{}.{}".format(rename[k.rsplit(".", 1)[0]],
                                       k.rsplit(".", 1)[1]) for k in jsd}
    for k, v in jsd.items():
        if k != "step":
            pname, slot = k.rsplit(".", 1)
            np.testing.assert_allclose(
                tsd[f"{rename[pname]}.{slot}"].float().numpy(),
                np.asarray(v._data, np.float32), atol=1e-6, rtol=1e-6,
                err_msg=k)
    jo2 = getattr(jopt, name)(parameters=jparams, **kw)
    to2 = getattr(topt, name)(parameters=tparams, **kw)
    jo2.set_state_dict(jsd)
    to2.set_state_dict(tsd)
    step(2, jo2, to2)
    for jp, tp in zip(jparams, tparams):
        np.testing.assert_allclose(tp.detach().float().numpy(),
                                   np.asarray(jp._data.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


def test_minimize_and_clear_grad():
    """``minimize(loss)`` is backward, step and clear_grad; clear_grad
    with ``set_to_zero`` keeps zeroed gradients."""
    torch.manual_seed(0)
    a = torch.nn.Parameter(torch.randn(3, 2))
    b = torch.nn.Parameter(a.detach().clone())
    x = torch.randn(5, 3)
    oa, ob = topt.SGD(0.1, parameters=[a]), topt.SGD(0.1, parameters=[b])
    oa.minimize((x @ a).square().sum())
    (x @ b).square().sum().backward()
    ob.step()
    assert torch.equal(a, b) and a.grad is None
    ob.clear_grad(set_to_zero=True)
    assert torch.equal(b.grad, torch.zeros_like(b))


# -- loss functions and layers ------------------------------------------------

def _loss_inputs():
    rng = np.random.RandomState(12)
    n, c = 6, 5
    f = np.float32
    labels = rng.randint(0, c, n)
    labels[1] = -100
    soft = rng.rand(n, c).astype(f)
    soft /= soft.sum(-1, keepdims=True)
    probs = (1 / (1 + np.exp(-rng.randn(n, c)))).astype(f)
    return dict(
        logits=rng.randn(n, c).astype(f), labels=labels,
        labels_col=labels[:, None].copy(), soft=soft,
        probs_rows=soft, weight=(rng.rand(c) + 0.5).astype(f),
        logits_t=rng.randn(c, n).astype(f),
        labels_ax0=rng.randint(0, c, (1, n)),
        logits3=rng.randn(2, 3, c).astype(f),
        labels3=rng.randint(0, c, (2, 3, 1)),
        logp=np.log(soft).astype(f),
        logp4=np.log(rng.rand(2, c, 2, 3).astype(f) + 0.1),
        labels4=rng.randint(0, c, (2, 2, 3)),
        a=rng.randn(n, c).astype(f), b=rng.randn(n, c).astype(f),
        probs=probs, targets=(rng.rand(n, c) > 0.5).astype(f),
        pos_weight=(rng.rand(c) + 0.5).astype(f),
        pm1=np.where(rng.rand(n) > 0.5, 1.0, -1.0).astype(f),
        pm1_nc=np.where(rng.rand(n, c) > 0.5, 1.0, -1.0).astype(f),
        x1=rng.randn(n).astype(f), x2=rng.randn(n).astype(f),
        anchor=rng.randn(n, c).astype(f), pos=rng.randn(n, c).astype(f),
        neg=rng.randn(n, c).astype(f), norm=np.asarray(3.0, f))


# (function, argument names, keyword arguments; a string value names an
# input array)
LOSS_CASES = {}
for _r in ("mean", "sum", "none"):
    LOSS_CASES.update({
        f"ce_hard_{_r}": ("cross_entropy", ("logits", "labels"),
                          dict(reduction=_r)),
        f"ce_weight_{_r}": ("cross_entropy", ("logits", "labels"),
                            dict(reduction=_r, weight="weight")),
        f"ce_soft_{_r}": ("cross_entropy", ("logits", "soft"),
                          dict(reduction=_r, soft_label=True)),
        f"nll_{_r}": ("nll_loss", ("logp", "labels"), dict(reduction=_r)),
        f"nll_weight_{_r}": ("nll_loss", ("logp", "labels"),
                             dict(reduction=_r, weight="weight")),
        f"mse_{_r}": ("mse_loss", ("a", "b"), dict(reduction=_r)),
        f"l1_{_r}": ("l1_loss", ("a", "b"), dict(reduction=_r)),
        f"smooth_l1_{_r}": ("smooth_l1_loss", ("a", "b"),
                            dict(reduction=_r, delta=0.5)),
        f"bce_{_r}": ("binary_cross_entropy", ("probs", "targets"),
                      dict(reduction=_r, weight="weight")),
        f"bce_logits_{_r}": ("binary_cross_entropy_with_logits",
                             ("a", "targets"), dict(reduction=_r)),
        f"bce_logits_pos_weight_{_r}": (
            "binary_cross_entropy_with_logits", ("a", "targets"),
            dict(reduction=_r, weight="weight", pos_weight="pos_weight")),
        f"kl_div_{_r}": ("kl_div", ("logp", "probs_rows"),
                         dict(reduction=_r)),
        f"hinge_{_r}": ("hinge_embedding_loss", ("a", "pm1_nc"),
                        dict(reduction=_r, margin=0.5)),
        f"margin_ranking_{_r}": ("margin_ranking_loss", ("x1", "x2", "pm1"),
                                 dict(reduction=_r, margin=0.1)),
        f"cosine_embedding_{_r}": ("cosine_embedding_loss",
                                   ("a", "b", "pm1"),
                                   dict(reduction=_r, margin=0.2)),
        f"triplet_{_r}": ("triplet_margin_loss", ("anchor", "pos", "neg"),
                          dict(reduction=_r)),
        f"focal_{_r}": ("sigmoid_focal_loss", ("a", "targets"),
                        dict(reduction=_r, normalizer="norm")),
    })
LOSS_CASES.update({
    "ce_label_column": ("cross_entropy", ("logits", "labels_col"), {}),
    "ce_smoothing": ("cross_entropy", ("logits", "labels"),
                     dict(label_smoothing=0.1)),
    "ce_smoothing_weight": ("cross_entropy", ("logits", "labels"),
                            dict(label_smoothing=0.2, weight="weight")),
    "ce_soft_detected": ("cross_entropy", ("logits", "soft"), {}),
    "ce_soft_smoothing": ("cross_entropy", ("logits", "soft"),
                          dict(soft_label=True, label_smoothing=0.1)),
    "ce_no_softmax": ("cross_entropy", ("probs_rows", "labels"),
                      dict(use_softmax=False)),
    "ce_axis_0": ("cross_entropy", ("logits_t", "labels_ax0"),
                  dict(axis=0)),
    "ce_3d": ("cross_entropy", ("logits3", "labels3"), {}),
    "ce_ignore_index_2": ("cross_entropy", ("logits", "labels"),
                          dict(ignore_index=2)),
    "swce": ("softmax_with_cross_entropy", ("logits", "labels_col"), {}),
    "swce_return_softmax": ("softmax_with_cross_entropy",
                            ("logits", "labels_col"),
                            dict(return_softmax=True)),
    "swce_soft": ("softmax_with_cross_entropy", ("logits", "soft"),
                  dict(soft_label=True)),
    "nll_spatial": ("nll_loss", ("logp4", "labels4"), {}),
    "nll_ignore_index_3": ("nll_loss", ("logp", "labels"),
                           dict(ignore_index=3)),
    "kl_div_batchmean": ("kl_div", ("logp", "probs_rows"),
                         dict(reduction="batchmean")),
    "triplet_p1_swap": ("triplet_margin_loss", ("anchor", "pos", "neg"),
                        dict(p=1.0, swap=True, margin=0.5)),
    "log_loss": ("log_loss", ("probs", "targets"), dict(epsilon=1e-3)),
    "square_error_cost": ("square_error_cost", ("a", "b"), {}),
    "focal_alpha_gamma": ("sigmoid_focal_loss", ("a", "targets"),
                          dict(alpha=0.4, gamma=1.5)),
})


def _resolve(inputs, names, kw, to):
    args = [to(inputs[n]) for n in names]
    kw = {k: to(inputs[v]) if isinstance(v, str) and k != "reduction"
          else v for k, v in kw.items()}
    return args, kw


def _to_jax(a):
    return pt.to_tensor(a)


def _to_torch(a):
    return torch.from_numpy(np.asarray(a))


def _compare(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w.numpy())
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=LOSS_ATOL,
                                   rtol=LOSS_RTOL)


def test_every_loss_function_is_covered():
    names = {c[0] for c in LOSS_CASES.values()}
    assert len(names) == 16
    assert all(hasattr(TF, n) for n in names)


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_function_matches_jax(case):
    fn, names, kw = LOSS_CASES[case]
    inputs = _loss_inputs()
    jargs, jkw = _resolve(inputs, names, kw, _to_jax)
    targs, tkw = _resolve(inputs, names, kw, _to_torch)
    _compare(getattr(TF, fn)(*targs, **tkw), getattr(JF, fn)(*jargs, **jkw))


# (layer, constructor keywords, argument names)
LAYER_CASES = {
    "CrossEntropyLoss": ("CrossEntropyLoss",
                         dict(weight="weight", label_smoothing=0.1,
                              reduction="sum"), ("logits", "labels")),
    "MSELoss": ("MSELoss", dict(reduction="none"), ("a", "b")),
    "L1Loss": ("L1Loss", dict(reduction="sum"), ("a", "b")),
    "SmoothL1Loss": ("SmoothL1Loss", dict(delta=0.3), ("a", "b")),
    "NLLLoss": ("NLLLoss", dict(weight="weight", ignore_index=4),
                ("logp", "labels")),
    "BCELoss": ("BCELoss", dict(weight="weight"), ("probs", "targets")),
    "BCEWithLogitsLoss": ("BCEWithLogitsLoss",
                          dict(pos_weight="pos_weight", reduction="sum"),
                          ("a", "targets")),
    "KLDivLoss": ("KLDivLoss", dict(reduction="batchmean"),
                  ("logp", "probs_rows")),
    "MarginRankingLoss": ("MarginRankingLoss", dict(margin=0.3),
                          ("x1", "x2", "pm1")),
    "HingeEmbeddingLoss": ("HingeEmbeddingLoss", dict(margin=2.0),
                           ("a", "pm1_nc")),
    "CosineEmbeddingLoss": ("CosineEmbeddingLoss",
                            dict(margin=0.1, reduction="sum"),
                            ("a", "b", "pm1")),
    "TripletMarginLoss": ("TripletMarginLoss",
                          dict(margin=0.5, p=1.0, swap=True),
                          ("anchor", "pos", "neg")),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_loss_layer_matches_jax(case):
    layer, kw, names = LAYER_CASES[case]
    inputs = _loss_inputs()
    jargs, jkw = _resolve(inputs, names, kw, _to_jax)
    targs, tkw = _resolve(inputs, names, kw, _to_torch)
    _compare(getattr(tnn, layer)(**tkw)(*targs),
             getattr(jnn, layer)(**jkw)(*jargs))


# -- recompute ----------------------------------------------------------------

@pytest.fixture(scope="module")
def recompute_reference():
    """The JAX model's loss and gradients with ``recompute=True`` (plain
    attention, one layer, s = 32), and its state."""
    before = pt.get_flags("use_flash_attention")["use_flash_attention"]
    pt.set_flags({"use_flash_attention": False})
    try:
        pt.seed(21)
        jm = JLlamaForCausalLM(JLlamaConfig.tiny(
            num_hidden_layers=1, recompute=True))
        rng = np.random.RandomState(21)
        ids = rng.randint(0, 128, (2, 32)).astype(np.int64)
        labels = rng.randint(0, 128, (2, 32)).astype(np.int64)
        labels[0, :5] = -100
        buffers = get_buffers(jm)

        def loss_of(params, i, lab):
            (_, loss), _ = call_functional(
                jm, params, buffers, (pt.to_tensor(i),),
                {"labels": pt.to_tensor(lab)})
            return loss

        loss, grads = jax.jit(jax.value_and_grad(loss_of))(
            get_params(jm), jnp.asarray(ids), jnp.asarray(labels))
    finally:
        pt.set_flags({"use_flash_attention": before})
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return state, ids, labels, float(loss), {
        k: np.asarray(v) for k, v in grads.items()}


def _port_loss_and_grads(state, ids, labels, **cfg):
    tm = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1, **cfg),
                          device="cpu")
    load_reference_state(tm, state)
    loss = llama_loss_fn(tm, torch.from_numpy(ids), torch.from_numpy(labels))
    loss.backward()
    return loss.detach(), {n: p.grad for n, p in tm.named_parameters()}


@pytest.mark.parametrize("granularity", ["full", "core_attn", "full_attn"])
def test_recompute_matches_plain_and_jax(recompute_reference, granularity):
    """Loss and every gradient: equal to the port without recompute (the
    CPU reruns the same operations), and to the JAX package with
    recompute on to 1e-5 absolute (gradients are O(1e-2))."""
    state, ids, labels, jloss, jgrads = recompute_reference
    plain_loss, plain = _port_loss_and_grads(state, ids, labels)
    loss, grads = _port_loss_and_grads(
        state, ids, labels, recompute=True,
        recompute_granularity=granularity)
    assert torch.equal(loss, plain_loss)
    for n, g in grads.items():
        assert torch.equal(g, plain[n]), n
        np.testing.assert_allclose(g.numpy(), jgrads[n], atol=1e-5,
                                   rtol=1e-4, err_msg=n)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)


def test_recompute_runs_the_layer_twice_only_with_gradients():
    """With gradients the checkpointed layer's forward runs again in the
    backward; without them (decoding, ``no_grad``) once."""
    from paddle_tpu_torch.distributed.fleet import recompute

    calls = []

    def body(x):
        calls.append(1)
        return torch.tanh(x @ x.t())

    x = torch.randn(4, 4, requires_grad=True)
    recompute(body, x, policy="core_attn").sum().backward()
    assert len(calls) == 2
    with torch.no_grad():
        recompute(body, x, policy="full")
    assert len(calls) == 3


# -- TrainStep ----------------------------------------------------------------

def _mlp_pair(seed=4):
    pt.seed(seed)
    jm = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    tm = torch.nn.Sequential(tnn.Linear(8, 16, device="cpu"), tnn.ReLU(),
                             tnn.Linear(16, 4, device="cpu"))
    load_reference_state(tm, {k: np.asarray(v.numpy())
                              for k, v in jm.state_dict().items()})
    return jm, tm


def _mlp_batch():
    rng = np.random.RandomState(31)
    return (rng.randn(10, 8).astype(np.float32),
            rng.randn(10, 4).astype(np.float32))


def _jloss(model, x, y):
    out = model(x)
    return JF.mse_loss(out, y), {"out": out}


def _tloss(model, x, y):
    out = model(x)
    return TF.mse_loss(out, y), {"out": out}


def _half(grads):
    return {n: g * 0.5 for n, g in grads.items()}


def _run_jax(jm, opt, steps=3, sched=None, **kw):
    x, y = _mlp_batch()
    step = JTrainStep(jm, opt, _jloss, return_outputs=True, **kw)
    out = []
    for _ in range(steps):
        loss, outs = step(pt.to_tensor(x), pt.to_tensor(y))
        out.append((float(loss), np.asarray(outs["out"].numpy())))
        if sched is not None:
            sched.step()
    return out, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _run_port(tm, opt, steps=3, sched=None, **kw):
    x, y = map(torch.from_numpy, _mlp_batch())
    step = TrainStep(tm, opt, _tloss, return_outputs=True, **kw)
    out = []
    for _ in range(steps):
        loss, outs = step(x, y)
        assert not outs["out"].requires_grad
        out.append((float(loss), outs["out"].numpy()))
        if sched is not None:
            sched.step()
    return out, {k: v.detach().numpy() for k, v in tm.state_dict().items()}


def _assert_runs_equal(a, b, tol):
    (sa, wa), (sb, wb) = a, b
    for (la, oa), (lb, ob) in zip(sa, sb):
        np.testing.assert_allclose(la, lb, rtol=tol, atol=tol)
        np.testing.assert_allclose(oa, ob, rtol=tol, atol=tol)
    for k in wa:
        np.testing.assert_allclose(wa[k], wb[k], rtol=tol, atol=tol,
                                   err_msg=k)


def test_trainstep_schedule_postprocess_outputs_match_jax():
    """3 AdamW steps under LinearWarmup over CosineAnnealingDecay with a
    ``grad_postprocess`` that halves every gradient and a clip: losses,
    the returned outputs and the weights equal the JAX TrainStep's to
    1e-5 (f32 sums in other orders; the weights move ~1e-2 a step), and
    the schedule moved the rate."""
    def sched(lr):
        return lr.LinearWarmup(lr.CosineAnnealingDecay(5e-2, T_max=4),
                               warmup_steps=2, start_lr=1e-2, end_lr=5e-2)

    jm, tm = _mlp_pair()
    js, ts = sched(jlr), sched(tlr)
    jrun = _run_jax(jm, jopt.AdamW(learning_rate=js, parameters=[],
                                   grad_clip=jnn.ClipGradByGlobalNorm(1.0)),
                    sched=js, grad_postprocess=_half)
    trun = _run_port(tm, topt.AdamW(learning_rate=ts,
                                    grad_clip=tnn.clip.ClipGradByGlobalNorm(
                                        1.0)),
                     sched=ts, grad_postprocess=_half)
    _assert_runs_equal(trun, jrun, 1e-5)
    assert ts.last_epoch == 3 and ts() != 1e-2
    assert trun[0][2][0] < trun[0][0][0]


@pytest.fixture(scope="module")
def adamw_baseline():
    """Both packages' plain AdamW runs on the MLP, the reference for the
    ignored options."""
    jm, tm = _mlp_pair()
    return (_run_jax(jm, jopt.AdamW(learning_rate=1e-2, parameters=[])),
            _run_port(tm, topt.AdamW(learning_rate=1e-2)))


def _group(model):
    params = list(model.parameters())
    return [{"params": params[:2], "learning_rate": 5.0,
             "weight_decay": 0.9}, {"params": params[2:]}]


@pytest.mark.parametrize("option", ["lr_ratio", "param_groups", "remat"])
def test_reference_ignores_option_and_port_does_too(adamw_baseline, option):
    """F4: each option leaves the trajectory as it is without it, in the
    JAX package and in the port alike (bit for bit against the baseline
    of each package, and the port to the JAX package to 1e-5)."""
    jbase, tbase = adamw_baseline
    jm, tm = _mlp_pair()
    jkw, tkw, jstep, tstep = {}, {}, {}, {}
    if option == "lr_ratio":
        jkw = tkw = dict(lr_ratio=lambda p: 0.1)
    elif option == "param_groups":
        jkw, tkw = dict(parameters=_group(jm)), dict(parameters=_group(tm))
    else:
        jstep = tstep = dict(remat=True)
    jkw.setdefault("parameters", [])
    jo = jopt.AdamW(learning_rate=1e-2, **jkw)
    to = topt.AdamW(learning_rate=1e-2, **tkw)
    if option == "param_groups":
        assert len(jo._parameter_list) == len(to._parameter_list) == 4
    jrun = _run_jax(jm, jo, **jstep)
    trun = _run_port(tm, to, **tstep)
    _assert_runs_equal(jrun, jbase, 0)
    _assert_runs_equal(trun, tbase, 0)
    _assert_runs_equal(trun, jrun, 1e-5)


def test_param_groups_eager_step_updates_every_parameter():
    """The eager step over parameter groups updates all their parameters
    at the optimizer's rate, as over the flat list."""
    torch.manual_seed(3)
    ps = [torch.nn.Parameter(torch.randn(3)) for _ in range(4)]
    qs = [torch.nn.Parameter(p.detach().clone()) for p in ps]
    go = topt.SGD(0.1, parameters=[{"params": ps[:2], "learning_rate": 9.0},
                                   {"params": ps[2:]}])
    fo = topt.SGD(0.1, parameters=qs)
    for p, q in zip(ps, qs):
        p.grad = torch.ones(3)
        q.grad = torch.ones(3)
    go.step()
    fo.step()
    for p, q in zip(ps, qs):
        assert torch.equal(p, q)
