"""Activation recomputation (port of ``distributed/fleet/recompute.py``).

The JAX package wraps the function in ``jax.checkpoint`` under tracing,
with a policy that names what XLA may keep instead of recomputing. The
port builds on ``torch.utils.checkpoint`` (non-reentrant, RNG state
preserved): the forward keeps only the function's inputs, and the
backward reruns the function to rebuild what it needs. The policies map
to selective checkpointing (``create_selective_checkpoint_contexts``):

- ``None`` and ``"full"``: save nothing, recompute everything;
- ``"core_attn"``: save the outputs of products with a 2-D weight
  (``aten.mm``/``aten.addmm``), as ``dots_with_no_batch_dims_saveable``
  does;
- ``"full_attn"``: save every product's output (``mm``, ``addmm``,
  ``bmm``, ``baddbmm``), as ``checkpoint_dots`` does.

Recomputation runs whenever gradients are enabled; the JAX package
recomputes only under tracing, and its eager path runs the function as
it is. The results are equal either way. With gradients off (decoding,
``torch.no_grad()``) the function runs once, as it is.

The flash-attention Function (kernels K1-K4 on the card) and the RMSNorm
Function (K6) launch kernels that are no aten product, so every policy
recomputes them, as every JAX policy recomputes the Pallas calls: a
recomputed Llama decoder layer launches the flash forward twice a step
(forward and recomputation) and K6 four times (its two norms, twice),
so a training step of L layers launches 2L flash forwards, L dq and L
dkv kernels and 4L + 1 K6 forwards (the final norm is outside the
layers) instead of L, L, L and 2L + 1.
"""

from __future__ import annotations

import functools

import torch

_ATEN = torch.ops.aten
# the products each policy keeps (None: keep nothing)
_SAVED_PRODUCTS = {
    None: None,
    "full": None,
    "core_attn": (_ATEN.mm.default, _ATEN.addmm.default),
    "full_attn": (_ATEN.mm.default, _ATEN.addmm.default, _ATEN.bmm.default,
                  _ATEN.baddbmm.default),
}


def _context_fn(saved):
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def recompute(function, *args, **kwargs):
    """Run ``function(*args, **kwargs)`` under activation checkpointing,
    as ``fleet.recompute`` does (fleet/recompute/recompute.py:404).
    ``policy``: ``None``, ``"full"``, ``"core_attn"`` or ``"full_attn"``
    (the module docstring says what each keeps). ``use_reentrant`` is
    accepted and ignored (the port is always non-reentrant);
    ``preserve_rng_state`` (default True) restores the RNG state for the
    rerun."""
    kwargs.pop("use_reentrant", None)
    preserve = kwargs.pop("preserve_rng_state", True)
    saved = _SAVED_PRODUCTS[kwargs.pop("policy", None)]
    if not torch.is_grad_enabled():
        return function(*args, **kwargs)
    from torch.utils.checkpoint import checkpoint

    extra = {} if saved is None else {"context_fn": _context_fn(saved)}
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve, **extra, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """Split a sequence of layers into ``ctx["segments"]`` segments and
    recompute each (recompute_sequential :542)."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    layers = list(functions)
    per = max(1, len(layers) // max(1, segments))
    out = args[0] if len(args) == 1 else args

    def run_seg(seg):
        def f(x):
            for layer in seg:
                x = layer(x)
            return x
        return f

    for i in range(0, len(layers), per):
        out = recompute(run_seg(layers[i:i + per]), out, **kwargs)
    return out


def recompute_hybrid(ctx, function, *args, **kwargs):
    """The model-parallel variant (recompute_hybrid.py): at mp=1 it is
    :func:`recompute`."""
    return recompute(function, *args, **kwargs)


class RecomputeFunction:
    """Name parity with fleet/recompute/recompute.py:108."""

    @staticmethod
    def apply(function, *args, **kwargs):
        return recompute(function, *args, **kwargs)


def mark_recompute(layer):
    """Wrap ``layer.forward`` in :func:`recompute`; returns the layer."""
    orig = layer.forward

    @functools.wraps(orig)
    def wrapped(*a, **k):
        return recompute(orig, *a, **k)

    layer.forward = wrapped
    return layer
