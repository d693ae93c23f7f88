"""ResNet (port of ``vision/models/resnet.py``): ``BasicBlock``,
``BottleneckBlock``, ``ResNet`` and the ``resnet18``-``152``, ``resnext*``
and ``wide_resnet*`` constructors.

The API is NCHW, as in Paddle. The model computes channel-last inside:
one transposing copy at the input edge, every conv, BatchNorm and pool
channel-last in memory; weights stay OIHW. (The JAX package does this under its
``layout_autotune`` flag, on by default.) The 7x7/s2 stem is one
convolution; the JAX package's space-to-depth form of it
(``resnet_space_to_depth``) is a rearrangement for the TPU's matrix unit
that computes the same function, and is not ported.

With ``use_fused_resnet_unit`` on, a training ``BottleneckBlock`` on
half-precision NHWC input whose row counts tile (``_fused_ok``) runs the
fused composition of the JAX package's ``_forward_fused``: the 1x1
convs through K7 and the stride-1 3x3 conv through K8 where
``supported_3x3`` holds (``ops/hopper/resnet_unit``), each BatchNorm's
statistics from the conv's f32 accumulator, and each scale/shift folded
into the next conv's prologue; the other 3x3 convs (stride 2, stage 4)
are PyTorch convolutions with plain statistics. This is a different
composition from the default path, so its results differ at the working
precision; the default computes what the JAX package computes by
default.

Entry points take ``device=None`` (the card; ``device="cpu"`` for the
plain path), a ``dtype`` for the parameters (BatchNorm's running
statistics stay f32) and a ``seed`` for the random weights.
"""

from __future__ import annotations

import torch
from torch import nn

from ... import flags
from ...framework.device import resolve_device, resolve_dtype
from ...nn.functional.norm import ema_update_stats
from ...nn.layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, Linear,
                         MaxPool2D, ReLU)
from ...ops.hopper.resnet_unit import (fused_conv1x1_bn, fused_conv3x3_bn,
                                       supported, supported_3x3)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 data_format="NCHW", *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(data_format=data_format, device=device, dtype=dtype)
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, generator=generator, **kw)
        self.bn1 = BatchNorm2D(planes, **kw)
        self.relu = ReLU()
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            generator=generator, **kw)
        self.bn2 = BatchNorm2D(planes, **kw)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


def _coeffs(bn, s1, s2, rows):
    """BatchNorm scale and shift (f32 ``[C]``) from the conv epilogue's
    sums, and the running-statistic update."""
    inv_r = 1.0 / rows
    mean = s1 * inv_r
    var = torch.maximum(s2 * inv_r - mean * mean, torch.zeros_like(mean))
    inv = torch.rsqrt(var + bn._epsilon) * bn.weight.float()
    shift = bn.bias.float() - mean * inv
    ema_update_stats(bn._mean, bn._variance, mean, var, bn._momentum,
                     rows / max(rows - 1, 1))
    return inv, shift


def _ssr(v, a, b, res=None):
    """``max(v * a + b (+ res), 0)`` in v's dtype: the f32 coefficients
    are cast down first, as in the JAX package."""
    o = v * a.to(v.dtype) + b.to(v.dtype)
    if res is not None:
        o = o + res
    return torch.maximum(o, torch.zeros((), dtype=v.dtype, device=v.device))


def _stats(v):
    """(sum, sum of squares) over all but the channel axis, f32
    accumulation over the input dtype."""
    axes = tuple(range(v.dim() - 1))
    v32 = v.float()
    return v.sum(dim=axes, dtype=torch.float32), (v32 * v32).sum(dim=axes)


def _unit(v, w_oihw, a=None, b=None):
    """A 1x1 conv through K7 on NHWC ``v``: (y NHWC, s1, s2)."""
    cout, cin = w_oihw.shape[:2]
    y, s1, s2 = fused_conv1x1_bn(v.reshape(-1, v.shape[-1]),
                                 w_oihw.reshape(cout, cin).t(), a, b)
    return y.reshape(*v.shape[:-1], cout), s1, s2


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, data_format="NCHW", *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self._data_format = data_format
        self._groups = groups
        self._stride = stride
        kw = dict(data_format=data_format, device=device, dtype=dtype)
        self.conv1 = Conv2D(inplanes, width, 1, bias_attr=False,
                            generator=generator, **kw)
        self.bn1 = BatchNorm2D(width, **kw)
        self.conv2 = Conv2D(width, width, 3, stride=stride, padding=1,
                            groups=groups, bias_attr=False,
                            generator=generator, **kw)
        self.bn2 = BatchNorm2D(width, **kw)
        self.conv3 = Conv2D(width, planes * self.expansion, 1,
                            bias_attr=False, generator=generator, **kw)
        self.bn3 = BatchNorm2D(planes * self.expansion, **kw)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        if self._fused_ok(x):
            return self._forward_fused(x)
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)

    def _fused_ok(self, x):
        """The fused path: training, channel-last, half precision, groups
        1, and row counts the kernels tile (as in the JAX package)."""
        if not (flags.flag_value("use_fused_resnet_unit") and self.training):
            return False
        if self._data_format != "NHWC" or self._groups != 1:
            return False
        if any(bn._use_global_stats for bn in (self.bn1, self.bn2, self.bn3)):
            return False
        if x.dim() != 4 or x.dtype not in (torch.bfloat16, torch.float16):
            return False
        if self.conv1.weight.dtype != x.dtype:
            return False
        n, h, w, cin = x.shape
        width = self.conv1.weight.shape[0]
        cout = self.conv3.weight.shape[0]
        s = self._stride
        if h % s or w % s:
            return False
        rows1, rows2 = n * h * w, n * (h // s) * (w // s)
        return supported(rows1, cin, width) and supported(rows2, width, cout)

    def _uses_3x3_kernel(self, x):
        """On the fused path, whether the 3x3 conv goes through K8 (else
        a PyTorch convolution with plain statistics)."""
        n, h, w, _ = x.shape
        width = self.conv1.weight.shape[0]
        return self._stride == 1 and supported_3x3(n, h, w, width, width)

    def _forward_fused(self, x):
        n, h, w, _ = x.shape
        s = self._stride
        rows1, rows2 = n * h * w, n * (h // s) * (w // s)
        y1, s1a, s1b = _unit(x, self.conv1.weight)
        a1, b1 = _coeffs(self.bn1, s1a, s1b, rows1)
        if self._uses_3x3_kernel(x):
            wt = self.conv2.weight
            cout, cin = wt.shape[:2]
            w9 = wt.permute(2, 3, 1, 0).reshape(9, cin, cout)
            y2, s2a, s2b = fused_conv3x3_bn(y1, w9, a1, b1)
        else:
            y2 = self.conv2(_ssr(y1, a1, b1))
            s2a, s2b = _stats(y2)
        a2, b2 = _coeffs(self.bn2, s2a, s2b, rows2)
        y3, s3a, s3b = _unit(y2, self.conv3.weight, a2, b2)
        a3, b3 = _coeffs(self.bn3, s3a, s3b, rows2)
        identity = x if self.downsample is None else self.downsample(x)
        return _ssr(y3, a3, b3, identity)


class ResNet(nn.Module):
    def __init__(self, block, depth_cfg, num_classes=1000, with_pool=True,
                 groups=1, width=64, data_format="NCHW", *, device=None,
                 dtype="float32", seed=0):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(dtype)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        self.groups, self.base_width = groups, width
        self.inplanes = 64
        self._input_format = data_format
        data_format = "NHWC"
        self._kw = dict(data_format=data_format, device=device, dtype=dtype)
        self.conv1 = Conv2D(3, 64, 7, stride=2, padding=3, bias_attr=False,
                            generator=gen, **self._kw)
        self.bn1 = BatchNorm2D(64, **self._kw)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(3, stride=2, padding=1,
                                 data_format=data_format)
        self.layer1 = self._make_layer(block, 64, depth_cfg[0], 1, gen)
        self.layer2 = self._make_layer(block, 128, depth_cfg[1], 2, gen)
        self.layer3 = self._make_layer(block, 256, depth_cfg[2], 2, gen)
        self.layer4 = self._make_layer(block, 512, depth_cfg[3], 2, gen)
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1, data_format=data_format)
        self.num_classes = num_classes
        if num_classes > 0:
            self.fc = Linear(512 * block.expansion, num_classes,
                             device=device, dtype=dtype, generator=gen)

    def _make_layer(self, block, planes, blocks, stride, generator):
        kw = dict(self._kw, generator=generator)
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **kw),
                BatchNorm2D(planes * block.expansion, **self._kw))
        if block is BottleneckBlock:
            kw.update(groups=self.groups, base_width=self.base_width)
        layers = [block(self.inplanes, planes, stride, downsample, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **kw))
        return nn.Sequential(*layers)

    def forward(self, x):
        if self._input_format == "NCHW":
            # one transposing copy at the input edge: a channel-last view
            # of NCHW memory would carry NCHW memory through every
            # convolution after it, and every BatchNorm and elementwise
            # pass would then stride across channels
            x = x.permute(0, 2, 3, 1).contiguous()
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return self._head(x)

    def _head(self, x):
        transposed = self._input_format == "NCHW"
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            if transposed and not self.with_pool:
                x = x.permute(0, 3, 1, 2)
            return self.fc(x.flatten(1))
        if transposed:
            # the NCHW API on feature-map exits
            x = x.permute(0, 3, 1, 2)
        return x


_CFGS = {
    18: (BasicBlock, [2, 2, 2, 2]),
    34: (BasicBlock, [3, 4, 6, 3]),
    50: (BottleneckBlock, [3, 4, 6, 3]),
    101: (BottleneckBlock, [3, 4, 23, 3]),
    152: (BottleneckBlock, [3, 8, 36, 3]),
}


def _resnet(depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not downloaded; load weights with "
            "paddle_tpu_torch.load_reference_state")
    block, cfg = _CFGS[depth]
    return ResNet(block, cfg, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(152, pretrained, **kwargs)


def _resnext(depth, groups, width, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are not downloaded; load weights with "
            "paddle_tpu_torch.load_reference_state")
    return ResNet(BottleneckBlock, _CFGS[depth][1], groups=groups,
                  width=width, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    return _resnext(50, 32, 4, pretrained, **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    return _resnext(50, 64, 4, pretrained, **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    return _resnext(101, 32, 4, pretrained, **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    return _resnext(101, 64, 4, pretrained, **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    return _resnext(152, 32, 4, pretrained, **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    return _resnext(152, 64, 4, pretrained, **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    return _resnext(50, 1, 128, pretrained, **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    return _resnext(101, 1, 128, pretrained, **kwargs)
