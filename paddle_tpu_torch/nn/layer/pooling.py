"""Pooling layers (port of ``nn/layer/pooling.py``: ``MaxPool2D`` and
``AdaptiveAvgPool2D``)."""

from __future__ import annotations

from torch import nn

from .. import functional as F
from ._layout import nhwc_compute


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        if return_mask:
            raise NotImplementedError("MaxPool2D(return_mask=True) is not "
                                      "ported yet")
        self._args = (kernel_size, stride, padding)
        self._ceil_mode = ceil_mode
        self._data_format = data_format

    def forward(self, x):
        def run(v, df):
            return F.max_pool2d(v, *self._args, ceil_mode=self._ceil_mode,
                                data_format=df)
        return nhwc_compute(x, self._data_format, run)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self._output_size = output_size
        self._data_format = data_format

    def forward(self, x):
        def run(v, df):
            return F.adaptive_avg_pool2d(v, self._output_size, df)
        return nhwc_compute(x, self._data_format, run)
