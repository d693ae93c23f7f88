"""Adam and AdamW (port of ``optimizer/optimizers.py``).

Plain PyTorch, in place on the TrainStep's f32 masters (or on the
parameters themselves when they are f32): the JAX update is XLA code,
not a kernel. The arithmetic follows the JAX package term by term.
"""

from __future__ import annotations

import torch

from .optimizer import Optimizer


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=True,
                 name=None):
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
    passes, do not exist in the port.)"""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 multi_precision=True, name=None):
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported yet")
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip,
                         multi_precision=multi_precision, name=name)
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update(self, p, g, slots, lr, step, wd=None):
        step_size = self._step_size(g, slots, lr, step)
        p.mul_(1 - lr * self._wd(wd)).sub_(step_size)

    def _param_wd(self, name):
        if (self._apply_decay_param_fun is not None
                and not self._apply_decay_param_fun(name)):
            return 0.0
        return self._decay_coeff()
