"""paddle_tpu_torch.amp (port of ``paddle_tpu/amp``): ``auto_cast`` O1/O2,
``decorate``, ``GradScaler`` and ``debugging`` over the port's one
op-cast point (``ops/registry.py``)."""

from . import amp_lists, debugging
from .auto_cast import amp_guard, auto_cast, decorate
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["AmpScaler", "GradScaler", "amp_guard", "amp_lists", "auto_cast",
           "debugging", "decorate", "is_bfloat16_supported",
           "is_float16_supported"]


def is_float16_supported(device=None):
    """fp16 computes on the card (the flash kernels take it) and on the
    CPU; the JAX package reports False only on a TPU."""
    return True


def is_bfloat16_supported(device=None):
    return True
