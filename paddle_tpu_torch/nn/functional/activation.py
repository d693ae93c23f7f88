"""Activations (port of ``nn/functional/activation.py``: ``gelu`` and the
simple activations of its ``_ACTS`` table, with ``logsigmoid``).

Each runs as the JAX package's op of its name (``ops/registry.py``: amp
casts its input, the stats hook sees its output) and follows its
``jax.nn`` body as a composition, so that autograd
differentiates it as JAX does (``relu6``'s gradient is 0 at 0 and at 6,
and ``hardswish`` goes through ``relu6``). Plain PyTorch: the JAX package
leaves them to XLA, with no kernel of its own.
"""

from __future__ import annotations

import torch

from ...ops.registry import named_op


@named_op("relu")
def relu(x):
    """``max(x, 0)`` with gradient 0 at 0, as ``jax.nn.relu``."""
    return torch.relu(x)


@named_op("relu6")
def relu6(x):
    """``min(max(x, 0), 6)`` with gradient 0 at 0 and at 6, as
    ``jax.nn.relu6``."""
    return torch.nn.functional.relu6(x)


@named_op("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@named_op("tanh")
def tanh(x):
    return torch.tanh(x)


@named_op("silu")
def silu(x):
    """``x * sigmoid(x)``, as ``jax.nn.silu``."""
    return torch.nn.functional.silu(x)


@named_op("swish")
def swish(x):
    return torch.nn.functional.silu(x)


def _softplus(x):
    """``log(1 + e^x)`` as ``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


@named_op("mish")
def mish(x):
    """``x * tanh(softplus(x))``, as ``jax.nn.mish``."""
    return x * torch.tanh(_softplus(x))


@named_op("softsign")
def softsign(x):
    """``x / (|x| + 1)``, as ``jax.nn.soft_sign``."""
    return x / (torch.abs(x) + 1)


@named_op("tanhshrink")
def tanhshrink(x):
    return x - torch.tanh(x)


@named_op("hardswish")
def hardswish(x):
    """``x * relu6(x + 3) / 6``, as ``jax.nn.hard_swish``."""
    return x * (relu6(x + 3.0) / 6.0)


@named_op("logsigmoid")
def logsigmoid(x):
    """``-softplus(-x)``, as ``jax.nn.log_sigmoid``."""
    return -_softplus(-x)


log_sigmoid = logsigmoid


@named_op("gelu")
def gelu(x, approximate=False):
    """GELU with Paddle's default, the exact (erf) form; ``approximate``
    takes the tanh form. The models call ``jax.nn.gelu`` directly, whose
    default is the tanh form: they pass ``approximate=True``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")
