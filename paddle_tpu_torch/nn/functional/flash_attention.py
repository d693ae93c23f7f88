"""Attention functionals (port of ``nn/functional/flash_attention.py``).

Layout as in the JAX package: q/k/v ``[batch, seqlen, heads, head_dim]``,
with K/V at ``kv_heads`` dividing ``heads`` (grouped-query attention).

``flash_attention`` runs the flash kernels' autograd Function
(``ops/hopper/flash_attention.py``), whose device picks the kernels (CUDA)
or their plain versions (CPU). As in the JAX package, attention dropout,
``return_softmax`` and an explicit ``attn_mask`` (through
``scaled_dot_product_attention``) go to the plain composition
``_reference_attention``: the JAX package computes those outside its
kernels too, so this is its routing, not a fallback. Dropout draws from
the ``torch.Generator`` the caller passes. Context parallelism (the
``sep`` ring) is not ported yet.

The ops carry the JAX package's names (``ops/registry.py``, for amp and
the operator stats): ``flash_attention`` where the JAX package would run
its Pallas kernel (both lengths multiples of 128, head_dim up to 256),
``flash_attention_ref`` where it would take its plain composition
(other shapes, dropout, ``return_softmax``), and ``sdpa`` with an
``attn_mask``. The name follows the reference's routing; the tensor's
device alone picks the port's kernels or their plain versions.
"""

from __future__ import annotations

import math

import torch

from ...ops.hopper.flash_attention import (FlashAttentionFunction,
                                            check_causal_lengths)
from ...ops.registry import named_op


def expand_gqa_kv(q, k, v):
    """Expand K/V heads to match q's, for the plain composition (the
    kernels never need this)."""
    if k.shape[2] != q.shape[2]:
        if q.shape[2] % k.shape[2]:
            raise ValueError(f"q heads {q.shape[2]} not a multiple of kv "
                             f"heads {k.shape[2]}")
        rep = q.shape[2] // k.shape[2]
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def _reference_attention(q, k, v, causal=False, dropout=0.0, bias=None,
                         scale=None, generator=None):
    """Plain composition: scores in f32 (plus ``bias``), causal mask,
    softmax, dropout with probability ``dropout`` drawn from
    ``generator``, probabilities cast to q's dtype before the product
    with V, as in the JAX package."""
    check_causal_lengths(q.shape[1], k.shape[1], causal)
    k, v = expand_gqa_kv(q, k, v)
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * s
    if bias is not None:
        logits = logits + bias.float()
    if causal:
        sq = logits.shape[-2]
        keep = torch.ones(sq, sq, dtype=torch.bool,
                          device=logits.device).tril()
        logits = logits.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if dropout > 0.0:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) >= dropout
        probs = torch.where(keep, probs / (1.0 - dropout),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def pallas_tiles(sq, sk, d):
    """Whether the JAX package would run its Pallas kernel at these
    lengths and head_dim (``ops/pallas/flash_attention.supported``)."""
    return sq % 128 == 0 and sk % 128 == 0 and d <= 256


def _kernels(query, key, value, causal):
    return FlashAttentionFunction.apply(
        query, key, value, bool(causal), 1.0 / math.sqrt(query.shape[-1]))


_flash = named_op("flash_attention")(_kernels)
_flash_at_ref_shape = named_op("flash_attention_ref")(_kernels)
_composition = named_op("flash_attention_ref")(_reference_attention)
_sdpa = named_op("sdpa")(_reference_attention)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None, generator=None):
    """Flash attention with the JAX package's signature; returns
    ``(out, None)`` as it does. Causal attention needs equal query and
    key lengths on both devices."""
    check_causal_lengths(query.shape[1], key.shape[1], causal)
    drop = dropout if training else 0.0
    if return_softmax or drop > 0.0:
        return _composition(query, key, value, causal=causal, dropout=drop,
                            generator=generator), None
    named = (_flash if pallas_tiles(query.shape[1], key.shape[1],
                                    query.shape[3])
             else _flash_at_ref_shape)
    return named(query, key, value, causal), None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """``attn_mask`` (an additive bias broadcasting to
    ``[b, heads, sq, sk]``) takes the plain composition; without one
    this is :func:`flash_attention`."""
    if attn_mask is None:
        out, _ = flash_attention(query, key, value, dropout=dropout_p,
                                 causal=is_causal, training=training,
                                 generator=generator)
        return out
    return _sdpa(query, key, value, causal=is_causal, bias=attn_mask,
                 dropout=dropout_p if training else 0.0, generator=generator)
