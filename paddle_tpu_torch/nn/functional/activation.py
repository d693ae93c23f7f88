"""Activations (port of ``nn/functional/activation.py``: ``relu``,
``gelu``, ``silu``)."""

from __future__ import annotations

import torch


def relu(x):
    """``max(x, 0)`` with gradient 0 at 0, as ``jax.nn.relu``."""
    return torch.relu(x)


def gelu(x, approximate=False):
    """GELU with Paddle's default, the exact (erf) form; ``approximate``
    takes the tanh form. The models call ``jax.nn.gelu`` directly, whose
    default is the tanh form: they pass ``approximate=True``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def silu(x):
    """``x * sigmoid(x)``, as ``jax.nn.silu``."""
    return torch.nn.functional.silu(x)
