"""The op-cast point of the port (the counterpart of what
``paddle_tpu/ops/registry.py``'s ``make_op`` does around an op).

The JAX package runs each named op through ``make_op``, which casts its
inputs for amp (``maybe_cast_inputs``), runs the body, then hands the
outputs to the operator-stats hook and the nan/inf check. The port has
PyTorch's autograd and no dispatcher of its own, so each functional op
that the JAX package runs through ``make_op`` is wrapped by
:func:`named_op` under the JAX op's name: :func:`amp_inputs` casts its
tensor arguments with ``Tensor.to`` (differentiable), and
:func:`op_outputs` calls ``OP_STATS_HOOK`` and the nan/inf check on what
it returns. Inside a named op its own PyTorch calls, and any named op it
calls, are neither cast again nor recorded, as a ``make_op`` body is raw
jax.
"""

from __future__ import annotations

import functools
import threading

import torch

from .. import flags
from ..amp.auto_cast import amp_state, maybe_cast_inputs

# installed by amp.debugging.enable_operator_stats_collection; called with
# (op_name, output tensors) after every named op
OP_STATS_HOOK = None

_local = threading.local()


def _tensors(outs):
    if isinstance(outs, torch.Tensor):
        return [outs]
    if isinstance(outs, (tuple, list)):
        return [o for o in outs if isinstance(o, torch.Tensor)]
    return []


def _check_nan_inf(name, outs):
    if OP_STATS_HOOK is not None:
        OP_STATS_HOOK(name, outs)
    if not flags.flag_value("check_nan_inf"):
        return
    for t in outs:
        if ((t.is_floating_point() or t.is_complex())
                and not bool(torch.isfinite(t).all())):
            msg = f"op {name!r} produced nan/inf"
            if flags.flag_value("check_nan_inf_level") >= 3:
                print("WARNING:", msg)
            else:
                raise FloatingPointError(msg)


def amp_inputs(name, *tensors):
    """``tensors`` cast for op ``name`` by the current ``auto_cast``
    state (a tuple; entries that are not tensors pass through)."""
    if getattr(_local, "depth", 0) or amp_state() is None:
        return tensors
    return tuple(maybe_cast_inputs(name, list(tensors)))


def op_outputs(name, outs):
    """Hand op ``name``'s outputs to the stats hook and the nan/inf
    check; returns ``outs``."""
    if not getattr(_local, "depth", 0) and (
            OP_STATS_HOOK is not None or flags.flag_value("check_nan_inf")):
        _check_nan_inf(name, _tensors(outs))
    return outs


def _active():
    return (amp_state() is not None or OP_STATS_HOOK is not None
            or flags.flag_value("check_nan_inf"))


def named_op(name, keep=()):
    """Decorator: run a functional op as the JAX package's op ``name``:
    its tensor arguments, positional or keyword, cast by amp (but for
    the keyword names in ``keep``, which the op updates in place and so
    must receive as they are: ``batch_norm``'s running statistics), its
    outputs recorded and checked."""
    def deco(fn):
        # positions of the ``keep`` parameters
        kept = {fn.__code__.co_varnames.index(k) for k in keep}

        @functools.wraps(fn)
        def op(*args, **kwargs):
            if getattr(_local, "depth", 0) or not _active():
                return fn(*args, **kwargs)
            if amp_state() is not None:
                pos = [i for i in range(len(args)) if i not in kept]
                keys = [k for k in kwargs if k not in keep]
                cast = amp_inputs(name, *(args[i] for i in pos),
                                  *(kwargs[k] for k in keys))
                args = list(args)
                for i, v in zip(pos, cast):
                    args[i] = v
                kwargs = dict(kwargs, **dict(zip(keys, cast[len(pos):])))
            _local.depth = 1
            try:
                outs = fn(*args, **kwargs)
            finally:
                _local.depth = 0
            return op_outputs(name, outs)
        op.op_name = name
        return op
    return deco
