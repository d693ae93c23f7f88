"""Activations (port of ``nn/functional/activation.py``: ``relu``)."""

from __future__ import annotations

import torch


def relu(x):
    """``max(x, 0)`` with gradient 0 at 0, as ``jax.nn.relu``."""
    return torch.relu(x)
