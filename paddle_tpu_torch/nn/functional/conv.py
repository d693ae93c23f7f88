"""Convolution (port of ``nn/functional/conv.py``: ``conv2d``).

The weight is OIHW, as in the JAX package and in PyTorch. A channel-last
input (``data_format="NHWC"``) goes to ``torch.nn.functional.conv2d`` as
a permuted view, whose memory is channels-last, with no copy; the result
is permuted back to NHWC, again a view. Convolutions the JAX package
leaves to XLA (``lax.conv_general_dilated``) are PyTorch's convolution
here, as its plain matrix products are ``torch.matmul``; the ones it
runs through its Pallas kernels go through ``ops/hopper/resnet_unit``.
"""

from __future__ import annotations

import torch.nn.functional as F


def _pair(v):
    if isinstance(v, (list, tuple)):
        if len(v) != 2:
            raise ValueError(f"want one value or two, got {v!r}")
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution of ``x`` (NCHW or NHWC) with an OIHW ``weight``
    and symmetric padding (one value, or one per spatial axis)."""
    if data_format not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format {data_format!r}: want NCHW or NHWC")
    channel_last = data_format == "NHWC"
    v = x.permute(0, 3, 1, 2) if channel_last else x
    out = F.conv2d(v, weight, bias, _pair(stride), _pair(padding),
                   _pair(dilation), groups)
    return out.permute(0, 2, 3, 1) if channel_last else out
