"""The optimizers (port of ``optimizer/optimizers.py``): SGD, Momentum,
Adam, AdamW, Adamax, Lamb, Adagrad, RMSProp, Adadelta, ASGD and Rprop.

Plain PyTorch, in place on the f32 masters (or on the parameters
themselves when they are f32) that ``TrainStep`` or the eager ``step()``
keeps: the JAX update is XLA code, not a kernel. The arithmetic follows
the JAX package term by term. As there, each constructor accepts and
ignores keywords it does not name (``**kw``).

Not ported: ``LBFGS``, which re-evaluates a closure inside ``step()``
(eager only; ROADMAP queue 1).
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer


class SGD(Optimizer):
    """``p -= lr * g`` with L2 ``weight_decay`` added to the gradient."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)

    def _update(self, p, g, slots, lr, step, wd=None):
        wd = self._wd(wd)
        if wd:
            g = g + wd * p
        p.sub_(lr * g)


class Momentum(Optimizer):
    """Heavy-ball momentum, optionally Nesterov, with L2 ``weight_decay``
    added to the gradient: ``v = momentum * v + g``, then ``p -= lr * v``
    (Nesterov: ``p -= lr * (g + momentum * v)``).

    As in the JAX package, the constructor takes no ``multi_precision``:
    any extra keyword, ``multi_precision`` among them, is accepted and
    ignored, so the base default (f32 master weights for half-precision
    parameters) always holds. That is a fault of the reference (ROADMAP
    queue 3, F3) which the port reproduces so that the two train alike.
    """

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._momentum = momentum
        self._nesterov = use_nesterov

    def _init_slots(self, param):
        return {"velocity": torch.zeros_like(param)}

    def _update(self, p, g, slots, lr, step, wd=None):
        wd = self._wd(wd)
        if wd:
            g = g + wd * p
        v = slots["velocity"].mul_(self._momentum).add_(g)
        if self._nesterov:
            p.sub_(lr * (g + self._momentum * v))
        else:
            p.sub_(lr * v)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_slots(self, param):
        return {"moment1": torch.zeros_like(param),
                "moment2": torch.zeros_like(param)}

    def _step_size(self, g, slots, lr, step):
        """Advance the moments in place; returns
        ``lr * mhat / (sqrt(vhat) + eps)``."""
        b1, b2 = self._beta1, self._beta2
        m = slots["moment1"].mul_(b1).add_(g, alpha=1 - b1)
        v = slots["moment2"].mul_(b2).add_(torch.square(g), alpha=1 - b2)
        mhat = m / (1 - b1 ** step)
        vhat = v / (1 - b2 ** step)
        return lr * mhat / (vhat.sqrt_() + self._eps)

    def _update(self, p, g, slots, lr, step, wd=None):
        wd = self._wd(wd)
        if wd:  # L2 regularisation into the gradient, unlike AdamW
            g = g + wd * p
        p.sub_(self._step_size(g, slots, lr, step))


class AdamW(Adam):
    """Decoupled weight decay. ``apply_decay_param_fun(name)`` returning
    False exempts a parameter; ``name`` is the port's structured name,
    such as ``llama.layers.0.input_layernorm.weight``. (Paddle's
    auto-names, such as ``llamarmsnorm_0.w_0``, which the JAX package
    passes, do not exist in the port.)

    ``lr_ratio`` is accepted and ignored, as the JAX package does: a
    fault of the reference (ROADMAP queue 3, F4) that the port
    reproduces so that the two train alike."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=True, name=None, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         multi_precision=multi_precision, name=name)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update(self, p, g, slots, lr, step, wd=None):
        step_size = self._step_size(g, slots, lr, step)
        p.mul_(1 - lr * self._wd(wd)).sub_(step_size)

    def _param_wd(self, name, param=None):
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(name)):
            return 0.0
        return self._decay_coeff()


class Adamax(Optimizer):
    """Adam over the infinity norm: ``u = max(beta2 * u, |g|)``,
    ``p -= lr / (1 - beta1^t) * m / (u + epsilon)``. ``weight_decay`` is
    kept but, as in the JAX package, not applied."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon

    def _init_slots(self, param):
        return {"moment": torch.zeros_like(param),
                "inf_norm": torch.zeros_like(param)}

    def _update(self, p, g, slots, lr, step, wd=None):
        b1 = self._beta1
        m = slots["moment"].mul_(b1).add_(g, alpha=1 - b1)
        u = torch.maximum(slots["inf_norm"].mul_(self._beta2), g.abs(),
                          out=slots["inf_norm"])
        p.sub_(lr / (1 - b1 ** step) * m / (u + self._eps))


class Lamb(Optimizer):
    """Layer-wise adaptive moments: Adam's step plus
    ``lamb_weight_decay * p``, scaled by the trust ratio
    ``|p| / |r|`` (1 where either norm is 0).
    ``exclude_from_weight_decay_fn(param)`` returning True exempts a
    parameter (it gets the parameter, as in the JAX package)."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name)
        self._beta1, self._beta2, self._eps = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _init_slots(self, param):
        return {"moment1": torch.zeros_like(param),
                "moment2": torch.zeros_like(param)}

    def _update(self, p, g, slots, lr, step, wd=None):
        b1, b2 = self._beta1, self._beta2
        m = slots["moment1"].mul_(b1).add_(g, alpha=1 - b1)
        v = slots["moment2"].mul_(b2).add_(torch.square(g), alpha=1 - b2)
        mhat = m / (1 - b1 ** step)
        vhat = v / (1 - b2 ** step)
        r = mhat / (vhat.sqrt_() + self._eps)
        r = r + self._wd(wd) * p
        w_norm = torch.linalg.vector_norm(p)
        r_norm = torch.linalg.vector_norm(r)
        trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        p.sub_(lr * trust * r)

    def _param_wd(self, name, param=None):
        if self._exclude_fn is not None and self._exclude_fn(param):
            return 0.0
        return self._decay_coeff()


class Adagrad(Optimizer):
    """``acc += g^2``, ``p -= lr * g / (sqrt(acc) + epsilon)``, with L2
    ``weight_decay`` added to the gradient."""

    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps = epsilon
        self._init_acc = initial_accumulator_value

    def _init_slots(self, param):
        return {"moment": torch.full_like(param, self._init_acc)}

    def _update(self, p, g, slots, lr, step, wd=None):
        wd = self._wd(wd)
        if wd:
            g = g + wd * p
        acc = slots["moment"].add_(torch.square(g))
        p.sub_(lr * g / (acc.sqrt() + self._eps))


class RMSProp(Optimizer):
    """``ms = rho * ms + (1 - rho) * g^2`` (centered: minus the square of
    the mean gradient), ``mom = momentum * mom + lr * g / sqrt(ms +
    epsilon)``, ``p -= mom``, with L2 ``weight_decay`` added to the
    gradient."""

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._eps = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _init_slots(self, param):
        slots = {"mean_square": torch.zeros_like(param),
                 "momentum": torch.zeros_like(param)}
        if self._centered:
            slots["mean_grad"] = torch.zeros_like(param)
        return slots

    def _update(self, p, g, slots, lr, step, wd=None):
        wd = self._wd(wd)
        if wd:
            g = g + wd * p
        rho = self._rho
        ms = slots["mean_square"].mul_(rho).add_(torch.square(g),
                                                 alpha=1 - rho)
        if self._centered:
            mg = slots["mean_grad"].mul_(rho).add_(g, alpha=1 - rho)
            denom = torch.sqrt(ms - torch.square(mg) + self._eps)
        else:
            denom = torch.sqrt(ms + self._eps)
        mom = slots["momentum"].mul_(self._momentum).add_(lr * g / denom)
        p.sub_(mom)


class Adadelta(Optimizer):
    """``asg = rho * asg + (1 - rho) * g^2``, ``u = -sqrt((asu + eps) /
    (asg + eps)) * g``, ``asu = rho * asu + (1 - rho) * u^2``,
    ``p += lr * u``, with L2 ``weight_decay`` added to the gradient."""

    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._eps, self._rho = epsilon, rho

    def _init_slots(self, param):
        return {"avg_squared_grad": torch.zeros_like(param),
                "avg_squared_update": torch.zeros_like(param)}

    def _update(self, p, g, slots, lr, step, wd=None):
        wd = self._wd(wd)
        if wd:
            g = g + wd * p
        rho, eps = self._rho, self._eps
        asg = slots["avg_squared_grad"].mul_(rho).add_(torch.square(g),
                                                       alpha=1 - rho)
        asu = slots["avg_squared_update"]
        update = -torch.sqrt((asu + eps) / (asg + eps)) * g
        asu.mul_(rho).add_(torch.square(update), alpha=1 - rho)
        p.add_(lr * update)


class ASGD(Optimizer):
    """Averaged SGD over a window of ``batch_num`` gradients: ``d`` is the
    sum of the last ``batch_num`` gradients (kept in ``ys``), and
    ``p -= lr * d / min(t, batch_num)``."""

    def __init__(self, learning_rate=0.001, batch_num=1, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._batch_num = max(int(batch_num), 1)

    def _init_slots(self, param):
        return {"d": torch.zeros_like(param),
                "ys": torch.zeros((self._batch_num,) + tuple(param.shape),
                                  dtype=param.dtype, device=param.device)}

    def _update(self, p, g, slots, lr, step, wd=None):
        wd = self._wd(wd)
        if wd:
            g = g + wd * p
        k = (step - 1) % self._batch_num
        d = slots["d"].sub_(slots["ys"][k]).add_(g)
        slots["ys"][k].copy_(g)
        p.sub_(lr * d / float(min(step, self._batch_num)))


class Rprop(Optimizer):
    """Resilient backprop: each element's step size grows by ``etas[1]``
    while its gradient keeps its sign and shrinks by ``etas[0]`` when it
    flips (within ``learning_rate_range``); a flip skips the step and
    forgets the gradient."""

    def __init__(self, learning_rate=0.001,
                 learning_rate_range=(1e-5, 50.0), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, multi_precision=False,
                 name=None, **kw):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas

    def _init_slots(self, param):
        return {"prev_grad": torch.zeros_like(param),
                "lrs": torch.full_like(param, self.get_lr())}

    def _update(self, p, g, slots, lr, step, wd=None):
        sign = torch.sign(g * slots["prev_grad"])
        factor = torch.where(
            sign > 0, torch.full_like(g, self._eta_pos),
            torch.where(sign < 0, torch.full_like(g, self._eta_neg),
                        torch.ones_like(g)))
        lrs = slots["lrs"].mul_(factor).clamp_(self._lr_min, self._lr_max)
        g_eff = torch.where(sign < 0, torch.zeros_like(g), g)
        p.sub_(lrs * torch.sign(g_eff))
        slots["prev_grad"].copy_(g_eff)
