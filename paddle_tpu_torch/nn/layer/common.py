"""Common layers (port of ``nn/layer/common.py``: ``Linear``)."""

from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from ._init import new_parameter, xavier_uniform_


class Linear(nn.Module):
    """``y = x W + b`` with ``W [in_features, out_features]``, as in
    Paddle. Weight XavierUniform from ``generator``, bias zeros;
    ``bias_attr=False`` drops the bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        if weight_attr is not None or bias_attr not in (None, False):
            raise NotImplementedError("Linear takes default parameter "
                                      "attributes")
        self.weight = new_parameter((in_features, out_features), device,
                                    dtype)
        xavier_uniform_(self.weight, in_features, out_features, generator)
        self.bias = None
        if bias_attr is not False:
            self.bias = new_parameter((out_features,), device, dtype)
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)
