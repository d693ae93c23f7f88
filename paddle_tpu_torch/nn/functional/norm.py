"""Normalisation functions (port of ``nn/functional/norm.py``:
``rms_norm`` only).

``rms_norm`` goes through ``RMSNormFunction`` on both devices, so it has
a gradient everywhere: the tensor's device picks the forward (the Triton
kernel K6 for a CUDA tensor, its plain version for a CPU tensor), and the
backward is the same plain PyTorch code on both. No flag chooses, and a
CUDA input never falls back.
"""

from __future__ import annotations

import torch

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
