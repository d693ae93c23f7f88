"""AMP autocast (port of ``paddle_tpu/amp/auto_cast.py``).

``auto_cast`` sets a thread-local state; the port's one op-cast point
(``ops/registry.py``) reads it and casts a named op's inputs by the op's
name: O1 casts white-list ops to the low dtype, black-list ops to f32,
and any other op to f32 when one of its inputs is f32; O2 casts
black-list ops to f32 and every other op to the low dtype. f64 and
non-float tensors are never cast. ``decorate`` casts a model's float
parameters and buffers for O2; the optimizers keep f32 master weights
(``multi_precision``). The casts are ``Tensor.to``, which autograd
differentiates, so a cotangent always reaches an op in its input's dtype.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ..framework.dtype import to_torch_dtype
from . import amp_lists

_state = threading.local()


def amp_state():
    return getattr(_state, "amp", None)


class _AmpState:
    __slots__ = ("enable", "dtype", "level", "white", "black")

    def __init__(self, enable, dtype, level, white, black):
        self.enable = enable
        self.dtype = dtype
        self.level = level
        self.white = white
        self.black = black


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Mirrors ``paddle.amp.auto_cast``: low dtype ``bfloat16`` by
    default, ``float16`` on request; a custom white-list name leaves the
    black list and a custom black-list name the white list."""
    white = set(amp_lists.white_list())
    black = set(amp_lists.black_list())
    if custom_white_list:
        white |= set(custom_white_list)
        black -= set(custom_white_list)
    if custom_black_list:
        black |= set(custom_black_list)
        white -= set(custom_black_list)
    prev = amp_state()
    _state.amp = _AmpState(enable, dtype, level, white, black)
    try:
        yield
    finally:
        _state.amp = prev


amp_guard = auto_cast


def _castable(t, target):
    return (isinstance(t, torch.Tensor) and t.is_floating_point()
            and t.dtype != target and t.dtype != torch.float64)


def maybe_cast_inputs(op_name, tensors):
    """``tensors`` (a list; entries that are not tensors pass through)
    cast for op ``op_name`` under the current ``auto_cast`` state."""
    st = amp_state()
    if st is None or not st.enable:
        return tensors
    if st.level == "O2":
        target = (torch.float32 if op_name in st.black
                  else to_torch_dtype(st.dtype))
    elif op_name in st.white:
        target = to_torch_dtype(st.dtype)
    elif op_name in st.black:
        target = torch.float32
    elif any(isinstance(t, torch.Tensor) and t.dtype == torch.float32
             for t in tensors):
        # promote: if any input is f32, compute in f32
        target = torch.float32
    else:
        return tensors
    return [t.to(target) if _castable(t, target) else t for t in tensors]


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """Mirrors ``paddle.amp.decorate``: for O2, every float parameter and
    buffer of each model is cast to ``dtype`` (as the JAX package's
    ``Layer.to(dtype=...)``); the optimizers keep f32 master weights.
    Returns the models, or ``(models, optimizers)`` when optimizers are
    given, shaped as they were passed."""
    single = not isinstance(models, (list, tuple))
    model_list = [models] if single else list(models)
    if level == "O2":
        low = to_torch_dtype(dtype)
        for m in model_list:
            with torch.no_grad():
                for t in list(m.parameters()) + list(m.buffers()):
                    if t.is_floating_point() and t.dtype != low:
                        t.data = t.data.to(low)
    if optimizers is None:
        return models if single else model_list
    return (models if single else model_list), optimizers
