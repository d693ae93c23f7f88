"""Activation layers (port of ``nn/layer/activation.py``: ``ReLU``)."""

from __future__ import annotations

from torch import nn

from .. import functional as F


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)
