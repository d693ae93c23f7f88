"""Activations (port of ``nn/functional/activation.py``: ``gelu`` and the
simple activations of its ``_ACTS`` table, with ``logsigmoid``).

Each follows its ``jax.nn`` body as a composition, so that autograd
differentiates it as JAX does (``relu6``'s gradient is 0 at 0 and at 6,
and ``hardswish`` goes through ``relu6``). Plain PyTorch: the JAX package
leaves them to XLA, with no kernel of its own.
"""

from __future__ import annotations

import torch


def relu(x):
    """``max(x, 0)`` with gradient 0 at 0, as ``jax.nn.relu``."""
    return torch.relu(x)


def relu6(x):
    """``min(max(x, 0), 6)`` with gradient 0 at 0 and at 6, as
    ``jax.nn.relu6``."""
    return torch.nn.functional.relu6(x)


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def silu(x):
    """``x * sigmoid(x)``, as ``jax.nn.silu``."""
    return torch.nn.functional.silu(x)


swish = silu


def _softplus(x):
    """``log(1 + e^x)`` as ``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mish(x):
    """``x * tanh(softplus(x))``, as ``jax.nn.mish``."""
    return x * torch.tanh(_softplus(x))


def softsign(x):
    """``x / (|x| + 1)``, as ``jax.nn.soft_sign``."""
    return x / (torch.abs(x) + 1)


def tanhshrink(x):
    return x - torch.tanh(x)


def hardswish(x):
    """``x * relu6(x + 3) / 6``, as ``jax.nn.hard_swish``."""
    return x * (relu6(x + 3.0) / 6.0)


def logsigmoid(x):
    """``-softplus(-x)``, as ``jax.nn.log_sigmoid``."""
    return -_softplus(-x)


log_sigmoid = logsigmoid


def gelu(x, approximate=False):
    """GELU with Paddle's default, the exact (erf) form; ``approximate``
    takes the tanh form. The models call ``jax.nn.gelu`` directly, whose
    default is the tanh form: they pass ``approximate=True``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")
