"""Gradient clipping by global norm (port of ``nn/clip.py``:
``ClipGradByGlobalNorm``, and the clip of ``jit/train_step.py``).

A non-finite gradient anywhere makes the norm non-finite, and the scale
factor then spreads it to every gradient: the clip reports a poisoned
step, it does not hide it (the JAX package pins the same behaviour).
"""

from __future__ import annotations

import torch


def clip_by_global_norm_(grads, clip_norm):
    """Scale ``grads`` (a list of tensors) in place by
    ``clip_norm / max(global_norm, clip_norm)``, the product taken in f32
    and cast back to each gradient's dtype. Returns the f32 global
    norm."""
    if not grads:
        return None
    norm = torch.stack([g.float().square().sum() for g in grads]).sum()
    norm = norm.sqrt()
    factor = clip_norm / torch.clamp(norm, min=clip_norm)
    for g in grads:
        g.copy_(g.float() * factor)
    return norm


class ClipGradByGlobalNorm:
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def __call__(self, params_grads):
        """``[(param, grad)]`` -> the same pairs with clipped copies of the
        gradients (``None`` gradients pass through)."""
        out = [(p, None if g is None else g.clone()) for p, g in params_grads]
        clip_by_global_norm_([g for _, g in out if g is not None],
                             self.clip_norm)
        return out
