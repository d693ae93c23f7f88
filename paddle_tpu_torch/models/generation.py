"""Autoregressive decoding with a static per-layer KV cache (port of
``models/generation.py``: ``cached_attention`` and
``generate_with_cache``).

``generate_with_cache`` sizes one ``[b, L, kv, d]`` buffer pair per layer
to the final length, runs one prefill, then one decode step per token.
PyTorch runs eagerly, so the loop is a Python loop and the buffers are
written in place. Greedy decoding matches the JAX package token for
token. Seeded sampling draws from a ``torch.Generator``, so it matches
the JAX package in distribution only (the serving engine samples
host-side with numpy and matches it exactly). ``quantize_for_decode``
is not ported yet.

``cached_attention`` is the model-facing attention for both cache
kinds: a ``PagedLayerCache`` (anything with ``block_tables``) routes to
the ragged paged attention of the serving pool; a ``(kbuf, vbuf)`` pair
is the dense path, a plain PyTorch masked softmax with no TPU kernel
behind it in the JAX package either.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def cached_attention(q, k, v, kv_cache, position_offset, *, kv_heads,
                     head_dim, out_dtype):
    """Write this chunk's K/V at ``position_offset`` and attend q
    against the cache. q ``[b, s, h, d]``; k/v ``[b, s, kv, d]``.
    Returns ``([b, s, h*d], cache)``."""
    if hasattr(kv_cache, "block_tables"):
        from ..serving.paged_attention import ragged_paged_attention
        return ragged_paged_attention(q, k, v, kv_cache, position_offset,
                                      kv_heads=kv_heads, head_dim=head_dim,
                                      out_dtype=out_dtype)
    kbuf, vbuf = kv_cache
    b, s, h, d = q.shape
    off = int(position_offset)
    # in place: JAX's dynamic_update_slice on donated buffers
    kbuf[:, off:off + s] = k.to(kbuf.dtype)
    vbuf[:, off:off + s] = v.to(vbuf.dtype)
    L = kbuf.shape[1]
    g = h // kv_heads
    qg = q.reshape(b, s, kv_heads, g, d)
    scores = torch.einsum("bqkgd,blkd->bqkgl", qg.float(),
                          kbuf.float()) / float(head_dim) ** 0.5
    rows = off + torch.arange(s, device=q.device)[:, None]
    cols = torch.arange(L, device=q.device)[None, :]
    scores = scores.masked_fill(~(cols <= rows)[None, :, None, None, :],
                                NEG_INF)
    p = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bqkgl,blkd->bqkgd", p, vbuf.float())
    return ctx.to(out_dtype).reshape(b, s, h * d), (kbuf, vbuf)


def _sample(logits, temperature, top_k, top_p, gen):
    """One token per row from f32 logits ``[b, vocab]``: the JAX
    package's temperature, top-k, then top-p (nucleus) math."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    logits = logits / float(temperature)
    if top_k and top_k > 0:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, NEG_INF)
    if top_p is not None and 0.0 < float(top_p) < 1.0:
        srt = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < float(top_p)
        cutoff = torch.where(keep, srt, torch.full_like(srt, float("inf"))
                             ).min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < cutoff, NEG_INF)
    return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                             generator=gen)[:, 0]


def generate_with_cache(model, input_ids, *, num_layers, kv_heads,
                        head_dim, max_positions, max_new_tokens=32,
                        temperature=0.0, top_k=0, top_p=1.0,
                        eos_token_id=None, seed=0):
    """Prompt ``[b, s0]`` -> ``[b, s0 + max_new_tokens]`` on the model's
    device. Rows that emit ``eos_token_id`` stay pinned to it, and the
    loop stops early when every row is done."""
    param = next(model.parameters())
    device = param.device
    ids = torch.as_tensor(input_ids, device=device)
    n_new = int(max_new_tokens)
    if n_new <= 0:
        return ids
    b, s0 = ids.shape
    L = s0 + n_new
    if L > max_positions:
        raise ValueError(
            f"prompt {s0} + max_new_tokens {max_new_tokens} exceeds max "
            f"position embeddings {max_positions}")
    # the first FLOATING parameter sets the KV dtype
    pdtype = next((p.dtype for p in model.parameters()
                   if p.is_floating_point()), torch.float32)
    caches = [(torch.zeros(b, L, kv_heads, head_dim, device=device,
                           dtype=pdtype),
               torch.zeros(b, L, kv_heads, head_dim, device=device,
                           dtype=pdtype))
              for _ in range(num_layers)]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = torch.empty(b, n_new, dtype=ids.dtype, device=device)
    with torch.no_grad():
        logits, caches = model(ids, kv_caches=caches, position_offset=0)
        nxt = _sample(logits[:, -1].float(), temperature, top_k, top_p, gen)
        done = (torch.zeros(b, dtype=torch.bool, device=device)
                if eos_token_id is None else nxt == eos_token_id)
        out[:, 0] = nxt
        for t in range(n_new - 1):
            if eos_token_id is not None and bool(done.all()):
                # every row is pinned to eos from here on
                out[:, t + 1:] = eos_token_id
                break
            logits, caches = model(out[:, t:t + 1], kv_caches=caches,
                                   position_offset=s0 + t)
            nxt = _sample(logits[:, -1].float(), temperature, top_k, top_p,
                          gen)
            if eos_token_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_token_id),
                                  nxt)
                done = done | (nxt == eos_token_id)
            out[:, t + 1] = nxt
    return torch.cat([ids, out], dim=1)
