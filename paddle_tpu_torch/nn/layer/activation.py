"""Activation layers (port of ``nn/layer/activation.py``: its ``_simple``
layers, each a call of the functional of its name)."""

from __future__ import annotations

from torch import nn

from .. import functional as F


def _simple(name, fn_name=None):
    fn = getattr(F, fn_name or name.lower())

    class _Act(nn.Module):
        def __init__(self, name=None):
            super().__init__()

        def forward(self, x):
            return fn(x)
    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _simple("ReLU")
ReLU6 = _simple("ReLU6")
Sigmoid = _simple("Sigmoid")
Tanh = _simple("Tanh")
Silu = _simple("Silu")
Swish = _simple("Swish")
Mish = _simple("Mish")
Softsign = _simple("Softsign")
Tanhshrink = _simple("Tanhshrink")
Hardswish = _simple("Hardswish")
LogSigmoid = _simple("LogSigmoid", "logsigmoid")
