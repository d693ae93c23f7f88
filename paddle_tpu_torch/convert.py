"""Load the JAX package's weights into the port's models.

The JAX package's ``state_dict()`` (turned into numpy arrays by the
caller) uses the same parameter and buffer names and the same
``[in, out]`` linear layout as the port, so weights and persistent
buffers (BatchNorm's ``_mean`` and ``_variance``) copy by name with no
transposes. The rotary tables are buffers that the JAX state dict
carries but does not persist; the port builds its own and skips them
here.

A quantized JAX state (after ``quantize_for_decode``: int8 weights and
f32 ``weight_scale`` buffers) loads into a quantized port model: the
int8 weights stay int8 and each ``weight_scale`` loads as a persistent
buffer. A quantized state into a float model, or a float state into a
quantized one, raises a ``ValueError`` that says which side is which.
"""

from __future__ import annotations

import numpy as np
import torch

# buffers the JAX state dict lists that the port rebuilds itself
_REBUILT_SUFFIXES = (".rope_cos", ".rope_sin")


def load_reference_state(model: torch.nn.Module,
                         arrays: dict[str, np.ndarray]) -> None:
    """Copy ``arrays`` (name -> array) into ``model``'s parameters and
    persistent buffers, cast to each one's dtype and device. Raises
    ``ValueError`` when one side is quantized (int8 weights) and the
    other is not, ``KeyError`` on a missing or extra name and
    ``ValueError`` on a shape or int8/float mismatch; nothing is touched
    unless every name, shape and kind checks out."""
    targets = dict(model.named_parameters())   # a tied weight once
    persistent = model.state_dict().keys()
    targets.update((n, b) for n, b in model.named_buffers()
                   if n in persistent)
    given = {k: v for k, v in arrays.items()
             if not k.endswith(_REBUILT_SUFFIXES)}
    state_q = any(np.asarray(v).dtype == np.int8 for v in given.values())
    model_q = any(t.dtype == torch.int8 for t in targets.values())
    if state_q != model_q:
        side = {True: "quantized (int8 weights)", False: "float"}
        raise ValueError(f"state/model mismatch: the state is "
                         f"{side[state_q]} and the model is "
                         f"{side[model_q]}; quantize both or neither "
                         f"(quantize_for_decode)")
    missing = sorted(set(targets) - set(given))
    extra = sorted(set(given) - set(targets))
    if missing or extra:
        raise KeyError(f"state mismatch: missing {missing}, extra {extra}")
    for name, p in targets.items():
        if tuple(np.shape(given[name])) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(np.shape(given[name]))} "
                             f"!= the model's {tuple(p.shape)}")
        got = np.asarray(given[name]).dtype
        if (got == np.int8) != (p.dtype == torch.int8):
            raise ValueError(f"{name}: the state's {got} against the "
                             f"model's {p.dtype} (int8 loads only into int8)")
    with torch.no_grad():
        for name, p in targets.items():
            p.copy_(torch.tensor(np.asarray(given[name])))
