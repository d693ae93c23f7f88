"""Normalisation functions (port of ``nn/functional/norm.py``:
``rms_norm`` only).

The tensor's device picks the implementation: a CUDA tensor goes to the
Triton kernel K6 (``ops/hopper/rms_norm.py``), a CPU tensor to its plain
version. No flag chooses, and a CUDA input never falls back.
"""

from __future__ import annotations

import torch

from ...ops.hopper.rms_norm import rms_norm_cuda, rms_norm_reference


def rms_norm(x, weight=None, epsilon=1e-6, axis=-1):
    """``x * rsqrt(mean(x^2, axis) + epsilon) * weight``, computed in
    f32 and returned in x's dtype."""
    if axis not in (-1, x.dim() - 1):
        raise ValueError(f"rms_norm normalises the last axis only, got "
                         f"axis={axis}")
    h = x.shape[-1]
    if weight is None:
        weight = torch.ones(h, device=x.device, dtype=x.dtype)
    x2d = x.reshape(-1, h)
    if x.is_cuda:
        out, _ = rms_norm_cuda(x2d, weight, epsilon)
    else:
        out, _ = rms_norm_reference(x2d, weight, epsilon)
    return out.reshape(x.shape)
