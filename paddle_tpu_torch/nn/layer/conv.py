"""Conv layer (port of ``nn/layer/conv.py``: ``Conv2D``). The weight is
OIHW, ``[out, in // groups, kh, kw]``, in both packages."""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import functional as F
from ..functional.conv import _pair
from ._init import kaiming_uniform_, new_parameter, uniform_
from ._layout import nhwc_compute


class Conv2D(nn.Module):
    """``bias_attr=False`` drops the bias. Weights: KaimingUniform over
    the fan-in, bias Uniform(+-1/sqrt(fan_in)), from ``generator``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        if padding_mode != "zeros" or weight_attr is not None \
                or bias_attr not in (None, False):
            raise NotImplementedError("Conv2D takes padding_mode='zeros' "
                                      "and default parameter attributes")
        self._kernel_size = _pair(kernel_size)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        self.weight = new_parameter(
            (out_channels, in_channels // groups, *self._kernel_size),
            device, dtype)
        self.bias = (None if bias_attr is False
                     else new_parameter((out_channels,), device, dtype))
        fan_in = in_channels // groups * math.prod(self._kernel_size)
        kaiming_uniform_(self.weight, fan_in, generator)
        if self.bias is not None:
            uniform_(self.bias, 1.0 / math.sqrt(fan_in), generator)

    def forward(self, x):
        def run(v, df):
            return F.conv2d(v, self.weight, self.bias, self._stride,
                            self._padding, self._dilation, self._groups, df)
        return nhwc_compute(x, self._data_format, run)
