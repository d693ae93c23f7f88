"""Pooling (port of ``nn/functional/pooling.py``: ``max_pool2d`` and
``adaptive_avg_pool2d``), NCHW or NHWC.

A channel-last input is pooled as a permuted view (channels-last memory)
and permuted back, as in ``conv2d``.
"""

from __future__ import annotations

import torch.nn.functional as F

from ...ops.registry import named_op
from .conv import _pair


def _to_nchw(x, data_format):
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format {data_format!r}: want NCHW or NHWC")
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _from_nchw(v, data_format):
    return v.permute(0, 2, 3, 1) if data_format == "NHWC" else v


@named_op("max_pool2d")
def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW"):
    """Max pool with -inf padding; ``stride`` defaults to the kernel."""
    if return_mask:
        raise NotImplementedError("max_pool2d(return_mask=True) is not "
                                  "ported yet")
    ks = _pair(kernel_size)
    st = ks if stride is None else _pair(stride)
    out = F.max_pool2d(_to_nchw(x, data_format), ks, st, _pair(padding),
                       ceil_mode=ceil_mode)
    return _from_nchw(out, data_format)


@named_op("adaptive_avg_pool2d")
def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Adaptive average pool. Where each output bin is a whole block of
    the input (the sizes divide), the block means over H and then over W,
    each rounded to the input dtype, as the JAX package computes them;
    else PyTorch's adaptive bins (the same floor/ceil edges)."""
    oh, ow = _pair(output_size)
    v = _to_nchw(x, data_format)
    n, c, h, w = v.shape
    if h % oh == 0 and w % ow == 0:
        out = v.reshape(n, c, oh, h // oh, w).mean(dim=3)
        out = out.reshape(n, c, oh, ow, w // ow).mean(dim=4)
    else:
        out = F.adaptive_avg_pool2d(v, (oh, ow))
    return _from_nchw(out, data_format)
