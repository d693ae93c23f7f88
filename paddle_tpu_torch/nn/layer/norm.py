"""BatchNorm layer (port of ``nn/layer/norm.py``: ``BatchNorm2D``).

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
