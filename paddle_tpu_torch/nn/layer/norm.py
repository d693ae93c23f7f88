"""Norm layers (port of ``nn/layer/norm.py``: ``LayerNorm``,
``GroupNorm`` and ``BatchNorm2D``).

``LayerNorm`` holds ``weight`` (ones) and ``bias`` (zeros) over
``normalized_shape``, as the JAX package names them, and runs
``nn.functional.layer_norm``; ``GroupNorm`` holds them over the channels
and runs ``nn.functional.group_norm``.

The running statistics are f32 buffers named ``_mean`` and
``_variance``, as in the JAX package's state dict (for example
``layer1.0.downsample.1._mean``), and follow Paddle's momentum
convention (see ``nn.functional.batch_norm``). They stay f32 when the
parameters are cast to bf16.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import functional as F
from ...framework.device import resolve_device
from ._init import new_parameter
from ._layout import nhwc_compute


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        ns = ([normalized_shape] if isinstance(normalized_shape, int)
              else list(normalized_shape))
        self._normalized_shape = ns
        self._epsilon = epsilon
        self.weight = (None if weight_attr is False
                       else new_parameter(ns, device, dtype))
        self.bias = (None if bias_attr is False
                     else new_parameter(ns, device, dtype))
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class GroupNorm(nn.Module):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=None, dtype=torch.float32):
        super().__init__()
        self._num_groups, self._epsilon = num_groups, epsilon
        self._data_format = data_format
        self.weight = (None if weight_attr is False
                       else new_parameter((num_channels,), device, dtype))
        self.bias = (None if bias_attr is False
                     else new_parameter((num_channels,), device, dtype))
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class BatchNorm2D(nn.Module):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = (None if weight_attr is False
                       else new_parameter((num_features,), device, dtype))
        self.bias = (None if bias_attr is False
                     else new_parameter((num_features,), device, dtype))
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()
        dev = resolve_device(device)
        self.register_buffer("_mean", torch.zeros(num_features, device=dev))
        self.register_buffer("_variance",
                             torch.ones(num_features, device=dev))

    def forward(self, x):
        def run(v, df):
            return F.batch_norm(v, self._mean, self._variance, self.weight,
                                self.bias, training=self.training,
                                momentum=self._momentum,
                                epsilon=self._epsilon, data_format=df,
                                use_global_stats=self._use_global_stats)
        return nhwc_compute(x, self._data_format, run)
