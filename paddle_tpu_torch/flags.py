"""Typed runtime flag registry (port of ``paddle_tpu/flags.py``).

One registry, three surfaces: :func:`define_flag` at import time,
``FLAGS_*`` environment variables read when a flag is defined, and
:func:`set_flags` / :func:`get_flags` at run time. Only the flags the
serving slice and the ResNet model read are defined here. The attention,
RMSNorm and BN-statistics kernels are not chosen by flags: the tensor's
device picks between a kernel and its plain version. The two ResNet
flags below choose something else, a different composition of the
training step (see their help).
"""

from __future__ import annotations

import os
import threading
from typing import Any

_LOCK = threading.RLock()
_REGISTRY: dict[str, "_Flag"] = {}


class _Flag:
    __slots__ = ("name", "type", "value", "default", "help")

    def __init__(self, name, type_, default, help_):
        self.name = name
        self.type = type_
        self.default = default
        self.value = default
        self.help = help_


def _parse(type_: type, raw: str) -> Any:
    if type_ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return type_(raw)


def define_flag(name: str, default: Any, help: str = "",
                type: type | None = None) -> None:
    """Register a flag. Env var ``FLAGS_<name>`` overrides the default."""
    type_ = type if type is not None else default.__class__
    with _LOCK:
        flag = _Flag(name, type_, default, help)
        env = os.environ.get("FLAGS_" + name)
        if env is not None:
            flag.value = _parse(type_, env)
        _REGISTRY[name] = flag


def _key(name: str) -> str:
    return name[len("FLAGS_"):] if name.startswith("FLAGS_") else name


def set_flags(flags: dict[str, Any]) -> None:
    """Set registered flags; mirrors ``paddle.set_flags``."""
    with _LOCK:
        for name, value in flags.items():
            key = _key(name)
            if key not in _REGISTRY:
                raise ValueError(f"unknown flag {name!r}")
            flag = _REGISTRY[key]
            if isinstance(value, str) and flag.type is not str:
                flag.value = _parse(flag.type, value)
            else:
                flag.value = flag.type(value)


def get_flags(names: str | list[str]) -> dict[str, Any]:
    """Read registered flags; mirrors ``paddle.get_flags``."""
    if isinstance(names, str):
        names = [names]
    with _LOCK:
        return {name: _REGISTRY[_key(name)].value for name in names}


def flag_value(name: str) -> Any:
    return _REGISTRY[name].value


# -- serving (serving/engine.py defaults; constructor kwargs override) ------
define_flag("serving_block_size", 16,
            "tokens per paged KV-cache block")
define_flag("serving_max_batch_slots", 8,
            "decode batch slots: the engine's fixed [slots, 1] decode batch")
define_flag("serving_prefill_chunk", 128,
            "largest prefill chunk per step; chunks pad up to power-of-two "
            "buckets capped here")
define_flag("serving_pool_blocks", 0,
            "KV pool blocks including the scratch block; 0 sizes the pool "
            "so every slot can hold a full-length context")
define_flag("serving_token_budget", 0,
            "tokens of work per engine step (decodes + prefill chunk); 0 "
            "means prefill_chunk + max_batch_slots")

# -- vision (vision/models/resnet.py, nn/functional/norm.py) ----------------
define_flag("use_fused_resnet_unit", False,
            "route training BottleneckBlocks (NHWC, bf16/f16, groups 1) "
            "through the fused conv+BN kernels K7 and K8: BN statistics "
            "come from the conv's f32 accumulator and each BN's "
            "scale/shift folds into the next conv's prologue. A different "
            "composition from the default path, so results differ at the "
            "working precision")
define_flag("use_pallas_bn_stats", False,
            "compute training BatchNorm statistics of bf16/f16 "
            "channel-last inputs (C % 128 == 0, rows % 8 == 0) with the "
            "statistics kernel K9 (mean and E[x^2] in f32)")
