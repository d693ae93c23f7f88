"""Model-parallel layers at mp=1 (port of ``distributed/fleet/mpu.py``).

The JAX package's layers shard over an ``mp`` mesh axis; at one
model-parallel rank they are dense layers, which is what the serving
slice needs. Tensor parallelism ports with distributed training.

The parameter name ``weight`` and Paddle's ``[in, out]`` linear layout
are kept, so a JAX state dict copies in by name with no transposes
(``paddle_tpu_torch/convert.py``). The matmuls are plain
``torch.matmul``: the JAX package leaves them to XLA outside any
kernel. Parameters are created uninitialised; the model that owns them
initialises them from its seeded generator.

After ``models.generation.quantize_for_decode`` a linear holds an int8
``weight`` and an f32 ``weight_scale`` buffer ``[1, out]``; its forward
is then ``(x @ q) * s`` in x's dtype through kernel K10
(``ops/hopper/int8_matmul.py``; the plain version on the CPU), with the
bias added after, and no autograd, as the JAX package's
``_int8_matmul``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...framework.dtype import promote
from ...ops.hopper.int8_matmul import int8_matmul


def _param(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


def quantized_matmul(layer, x):
    """``(x @ q) * s`` for a layer that ``quantize_for_decode`` converted
    (an int8 ``weight`` and a ``weight_scale`` buffer), else None: the
    dense path."""
    ws = getattr(layer, "weight_scale", None)
    if ws is None or layer.weight.dtype != torch.int8:
        return None
    return int8_matmul(x, layer.weight, ws)


class VocabParallelEmbedding(nn.Module):
    """Embedding table ``weight [num_embeddings, embedding_dim]``."""

    def __init__(self, num_embeddings, embedding_dim, *, device, dtype):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = _param((num_embeddings, embedding_dim), device, dtype)

    def forward(self, ids):
        return self.weight[ids]


class ColumnParallelLinear(nn.Module):
    """``x @ weight (+ bias)`` with ``weight [in_features, out_features]``.
    ``gather_output`` is kept for signature parity; at mp=1 the output
    is always whole."""

    def __init__(self, in_features, out_features, *, has_bias=True,
                 gather_output=True, device, dtype):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.gather_output = gather_output
        self.weight = _param((in_features, out_features), device, dtype)
        self.bias = (_param((out_features,), device, dtype)
                     if has_bias else None)

    def forward(self, x):
        out = quantized_matmul(self, x)
        if out is None:
            out = torch.matmul(*promote(x, self.weight))
        return out if self.bias is None else out + self.bias


class RowParallelLinear(ColumnParallelLinear):
    """The same dense product; at mp=1 there is no partial sum to
    all-reduce. ``input_is_parallel`` is kept for signature parity."""

    def __init__(self, in_features, out_features, *, has_bias=True,
                 input_is_parallel=False, device, dtype):
        super().__init__(in_features, out_features, has_bias=has_bias,
                         device=device, dtype=dtype)
        self.input_is_parallel = input_is_parallel
