"""Optimizer base (port of ``optimizer/optimizer.py``).

The numeric update is ``_init_slots`` / ``_update`` over f32 (or
working-dtype) tensors, which ``jit.TrainStep`` drives. As in the JAX
package, the optimizer keeps the learning rate, the weight-decay
coefficient, the gradient clip and the ``multi_precision`` switch; the
f32 master weights and the slots live in the ``TrainStep``. ``_update``
works in place: the JAX step donates these buffers, so nothing else
holds them.

Not ported yet: learning-rate schedulers, param groups, the eager
``step()``/``minimize()`` path and ``state_dict``.
"""

from __future__ import annotations


class Optimizer:
    """``parameters`` and ``name`` are accepted for the JAX package's
    signature; ``TrainStep`` takes the parameters from its model."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=True):
        if not isinstance(learning_rate, (int, float)):
            raise NotImplementedError("learning-rate schedulers are not "
                                      "ported yet; pass a number")
        self._learning_rate = float(learning_rate)
        self._grad_clip = grad_clip
        self._weight_decay = weight_decay
        self._multi_precision = multi_precision

    def _init_slots(self, param) -> dict:
        return {}

    def _update(self, p, g, slots, lr, step, wd=None):
        """Update ``p`` and ``slots`` in place from gradient ``g`` (same
        dtype as ``p``) at 1-based ``step``. ``wd``: the decay
        coefficient for this parameter (None = the optimizer's)."""
        raise NotImplementedError

    def _wd(self, wd):
        return self._decay_coeff() if wd is None else wd

    def _param_wd(self, name):
        """Effective weight-decay coefficient of the parameter ``name``;
        subclasses exclude parameters here."""
        return self._decay_coeff()

    def _decay_coeff(self):
        return 0.0 if self._weight_decay is None else float(
            self._weight_decay)

    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value):
        self._learning_rate = float(value)
