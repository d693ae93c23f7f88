"""Parameter construction and the JAX package's initialisers, drawn from
a caller's ``torch.Generator`` (no global random state)."""

from __future__ import annotations

import math

import torch
from torch import nn

from ...framework.device import resolve_device, resolve_dtype


def new_parameter(shape, device, dtype):
    """An uninitialised parameter on ``device`` (None: the card)."""
    return nn.Parameter(torch.empty(shape, device=resolve_device(device),
                                    dtype=resolve_dtype(dtype)))


def uniform_(p, limit, generator):
    """Uniform(-limit, limit), drawn in f32 and cast to p's dtype."""
    with torch.no_grad():
        v = torch.empty(p.shape, device=p.device, dtype=torch.float32)
        v.uniform_(-limit, limit, generator=generator)
        p.copy_(v)


def kaiming_uniform_(p, fan_in, generator):
    """The JAX package's KaimingUniform (leaky-relu gain, slope 0)."""
    uniform_(p, math.sqrt(2.0) * math.sqrt(3.0 / fan_in), generator)


def xavier_uniform_(p, fan_in, fan_out, generator):
    uniform_(p, math.sqrt(6.0 / (fan_in + fan_out)), generator)
