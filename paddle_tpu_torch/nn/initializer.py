"""Weight initialisers (port of ``nn/initializer.py``: ``Constant``,
``Normal`` and ``XavierUniform``, the ones the transformer models use).

An initialiser fills a parameter in place, drawing from the caller's
``torch.Generator`` (no global random state): ``init(param, generator)``.
Random draws are made in f32 and cast to the parameter's dtype, as the
JAX package draws them. The draws are the port's own; parity with the
JAX package copies weights (``load_reference_state``).
"""

from __future__ import annotations

import torch

from .layer._init import xavier_uniform_


class Constant:
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, param, generator=None):
        with torch.no_grad():
            param.fill_(self.value)
        return param


class Normal:
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def __call__(self, param, generator=None):
        with torch.no_grad():
            v = torch.empty(param.shape, device=param.device,
                            dtype=torch.float32)
            v.normal_(self.mean, self.std, generator=generator)
            param.copy_(v)
        return param


class XavierUniform:
    """Uniform(-limit, limit), ``limit = sqrt(6 / (fan_in + fan_out))``,
    with Paddle's fans of a ``[in, out]`` weight."""

    def __call__(self, param, generator=None):
        fan_in, fan_out = param.shape
        xavier_uniform_(param, fan_in, fan_out, generator)
        return param
