"""Dtype names (port of the part of ``paddle_tpu/framework/dtype.py`` that
amp reads: ``to_jax_dtype``, here :func:`to_torch_dtype`)."""

from __future__ import annotations

import torch

_BY_NAME = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}


def to_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a Paddle dtype name such as
    ``"bfloat16"`` (``"float"`` and ``"half"`` are not Paddle names and
    raise, as in the JAX package)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _BY_NAME[str(dtype)]
    except KeyError:
        raise ValueError(f"unknown dtype {dtype!r}") from None


def promote(*tensors):
    """``tensors`` cast to their promoted dtype where they differ, as
    ``jnp`` promotes the operands of a raw product (``f32 @ bf16`` is f32
    there; PyTorch's matmul takes one dtype). Under amp an op's output
    meets the model's own weights in another dtype at such products."""
    dt = tensors[0].dtype
    if all(t.dtype == dt for t in tensors[1:]):
        return tensors
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in tensors)
