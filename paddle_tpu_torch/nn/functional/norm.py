"""Normalisation functions (port of ``nn/functional/norm.py``:
``rms_norm``, ``batch_norm`` and ``ema_update_stats``).

``rms_norm`` goes through ``RMSNormFunction`` on both devices, so it has
a gradient everywhere: the tensor's device picks the forward (the CUDA
kernel K6 for a CUDA tensor, its plain version for a CPU tensor), and the
backward is the same plain PyTorch code on both. No flag chooses, and a
CUDA input never falls back.

``batch_norm`` writes the JAX package's formula in plain PyTorch (not
``F.batch_norm``): statistics with f32 accumulation (two-pass for f32
input; ``mean`` and ``E[x^2]`` for half-precision input, with
``var = max(E[x^2] - mean^2, 0)``), then ``x * A + B`` with per-channel
f32 ``A``, ``B`` cast to the input dtype. With ``use_pallas_bn_stats``
on, half-precision channel-last statistics come from K9
(``ops/hopper/bn_stats``) where its shape rule holds. Running statistics
follow Paddle's convention, ``running = momentum * running + (1 -
momentum) * batch`` (the opposite of PyTorch's), with the unbiased
batch variance, updated in place.
"""

from __future__ import annotations

import torch

from ... import flags
from ...ops.hopper.bn_stats import bn_stats
from ...ops.hopper.bn_stats import supported as bn_stats_supported
from ...ops.hopper.rms_norm import RMSNormFunction


def rms_norm(x, weight=None, epsilon=1e-6, axis=-1):
    """``x * rsqrt(mean(x^2, axis) + epsilon) * weight``, computed in
    f32 and returned in x's dtype."""
    if axis not in (-1, x.dim() - 1):
        raise ValueError(f"rms_norm normalises the last axis only, got "
                         f"axis={axis}")
    h = x.shape[-1]
    if weight is None:
        weight = torch.ones(h, device=x.device, dtype=x.dtype)
    out = RMSNormFunction.apply(x.reshape(-1, h), weight, float(epsilon))
    return out.reshape(x.shape)


def ema_update_stats(running_mean, running_var, batch_mean, batch_var,
                     momentum, unbiased_factor):
    """``running = momentum * running + (1 - momentum) * batch`` (the
    variance's batch term times ``unbiased_factor``), in place, outside
    autograd; the buffers keep their dtype."""
    mom, unb = float(momentum), float(unbiased_factor)
    with torch.no_grad():
        m, v = batch_mean.detach(), batch_var.detach()
        running_mean.copy_(mom * running_mean + (1 - mom) * m)
        running_var.copy_(mom * running_var + (1 - mom) * v * unb)


def _channel_axis(data_format):
    if data_format[1] == "C" and len(data_format) > 2:
        return 1
    if data_format == "NCL":
        return 1
    return -1 if data_format.endswith("C") else 1


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW", use_global_stats=None):
    """BatchNorm over every axis but the channel axis of
    ``data_format``. In training mode (and ``use_global_stats`` not
    set) the batch statistics normalise and the running statistics are
    updated in place; otherwise the running statistics normalise."""
    ca = _channel_axis(data_format) % x.dim()
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    dt = x.dtype
    shape = [1] * x.dim()
    shape[ca] = x.shape[ca]

    def scale_shift(mean, var):
        inv = torch.rsqrt(var.float() + epsilon)
        if weight is not None:
            inv = inv * weight.float()
        shift = -mean.float() * inv
        if bias is not None:
            shift = shift + bias.float()
        return x * inv.to(dt).reshape(shape) + shift.to(dt).reshape(shape)

    if use_stats:
        return scale_shift(running_mean, running_var)

    axes = tuple(i for i in range(x.dim()) if i != ca)
    c = x.shape[ca]
    rows = x.numel() // c
    mean = None
    if dt in (torch.float32, torch.float64):
        # two-pass centred variance: E[x^2] - E[x]^2 cancels badly in f32
        mean_k = x.mean(dim=axes, keepdim=True)
        mean = mean_k.reshape(c)
        var = ((x - mean_k) * (x - mean_k)).mean(dim=axes)
    else:
        if (ca == x.dim() - 1 and flags.flag_value("use_pallas_bn_stats")
                and bn_stats_supported(rows, c)):
            mean, m2 = bn_stats(x.reshape(rows, c))
        else:
            x32 = x.float()
            mean = x32.mean(dim=axes)
            m2 = (x32 * x32).mean(dim=axes)
        var = torch.maximum(m2 - mean * mean, torch.zeros_like(m2))
    out = scale_shift(mean, var)
    if training and running_mean is not None:
        ema_update_stats(running_mean, running_var, mean, var, momentum,
                         rows / max(rows - 1, 1))
    return out
