"""Numerical-debug helpers (port of ``paddle_tpu/amp/debugging.py``).

The tensor checker flips the ``check_nan_inf`` flags, which the port's
op-cast point (``ops/registry.py``) reads after every named op;
operator stats are gathered by a hook installed there for the scope of
``collect_operator_stats``, and printed as the JAX package prints them.
"""

from __future__ import annotations

import contextlib
from enum import Enum

import torch

from .. import flags

__all__ = [
    "DebugMode", "TensorCheckerConfig", "enable_tensor_checker",
    "disable_tensor_checker", "collect_operator_stats",
    "enable_operator_stats_collection", "disable_operator_stats_collection",
    "compare_accuracy",
]

# the JAX package's dtype names, which the stats table prints
_DTYPE_NAMES = {torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.float32: "float32", torch.float64: "float64",
                torch.complex64: "complex64", torch.complex128: "complex128"}


class DebugMode(Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL_FOR_OVERFLOW = 2
    CHECK_ALL = 3


class TensorCheckerConfig:
    def __init__(self, enable=True,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir=None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list


def enable_tensor_checker(config: TensorCheckerConfig):
    """Flip the per-op nan/inf scan (``check_nan_inf``): raise at level
    0, print at level 3."""
    flags.set_flags({
        "check_nan_inf": bool(config.enable),
        "check_nan_inf_level":
            0 if config.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT
            else 3,
    })


def disable_tensor_checker():
    flags.set_flags({"check_nan_inf": False})


# -- operator stats -----------------------------------------------------------

_collected: list[dict] | None = None


def _op_stats_hook(name, outs):
    if _collected is None:
        return
    for t in outs:
        if not (t.is_floating_point() or t.is_complex()):
            continue
        a = t.detach()
        af = (a.abs() if a.is_complex() else a).to("cpu", torch.float32)
        finite = af[~torch.isnan(af)]
        _collected.append({
            "op": name,
            "dtype": _DTYPE_NAMES.get(t.dtype, str(t.dtype)),
            "num_nan": int(torch.isnan(af).sum()),
            "num_inf": int(torch.isinf(af).sum()),
            "max": float(finite.max()) if finite.numel() else 0.0,
            "min": float(finite.min()) if finite.numel() else 0.0,
        })


def enable_operator_stats_collection():
    global _collected
    _collected = []
    from ..ops import registry
    registry.OP_STATS_HOOK = _op_stats_hook


def disable_operator_stats_collection():
    """Print the per-op summary table (the reference's) and clear;
    returns the collected stats."""
    global _collected
    from ..ops import registry
    registry.OP_STATS_HOOK = None
    stats = _collected or []
    _collected = None
    by_dtype: dict[tuple, list] = {}
    for s in stats:
        by_dtype.setdefault((s["op"], s["dtype"]), []).append(s)
    print("<------------------------------ op list "
          "------------------------------->")
    print(f"{'op':<32}{'dtype':<12}{'calls':<8}{'nan':<6}{'inf':<6}")
    for (name, dt), items in sorted(by_dtype.items()):
        print(f"{name:<32}{dt:<12}{len(items):<8}"
              f"{sum(i['num_nan'] for i in items):<6}"
              f"{sum(i['num_inf'] for i in items):<6}")
    return stats


@contextlib.contextmanager
def collect_operator_stats():
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    raise NotImplementedError(
        "compare_accuracy consumes the reference's binary op-dump files; "
        "use collect_operator_stats() on both runs and diff the returned "
        "stats instead")
