"""Llama (port of ``models/llama.py``): the KV-cache path for serving
and the cache-less path for training.

The model runs RMSNorm (kernel K6 on the card, with its gradient),
rotary embeddings, GQA attention and dense matmuls. With KV caches,
attention goes through ``models/generation.cached_attention`` (kernel
K5 for paged caches on the card). Without them it is causal flash
attention (``nn.functional.flash_attention``: the flash kernels on the
card), or the plain composition with an additive bias when the caller
passes ``attn_mask``, as in the JAX package. Parameter names and
Paddle's ``[in, out]`` linear layout follow the JAX package, so its
state dict loads by name (``paddle_tpu_torch/convert.py``).

``config.recompute`` checkpoints each decoder layer in the cache-less
forward (``distributed/fleet/recompute.py``) under
``recompute_granularity`` ``full``, ``core_attn`` or ``full_attn``, as
the JAX package does; cached decoding never recomputes. After
``models.generation.quantize_for_decode`` the linears and an untied LM
head run the weight-only int8 product (kernel K10 on the card); the
fused head loss reads the head's weight as it is.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..distributed.fleet.mpu import (ColumnParallelLinear, RowParallelLinear,
                                     VocabParallelEmbedding, quantized_matmul)
from ..distributed.fleet.recompute import recompute
from ..framework.device import resolve_device, resolve_dtype
from ..nn import functional as F


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    # kept for the JAX config's signature: there too the model does not
    # read it (the attention implementation is not a config choice)
    use_flash_attention: bool = True
    recompute: bool = False
    recompute_granularity: str = "full"
    # LM head + cross-entropy in token chunks, each under activation
    # checkpointing, so the [b*s, vocab] logits are never whole
    fused_head_loss: bool = False
    dtype: str = "float32"

    @staticmethod
    def llama2_7b(**kw):
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128)
        base.update(kw)
        return LlamaConfig(**base)


def _rope_tables(head_dim, max_pos, theta, device):
    """cos/sin ``[max_pos, head_dim]`` in f32, computed as the JAX
    package does."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32)
                           / head_dim))
    t = torch.arange(max_pos, dtype=torch.float32)
    freqs = torch.outer(t, inv)                                  # [P, D/2]
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(device), emb.sin().to(device)


def _mask_to_bias(attn_mask, seqlen):
    """A user mask as an additive f32 bias over ``[b, heads, q, k]``.

    Accepts the Paddle conventions, as the JAX package does: bool or
    integer (nonzero = attend) or an additive float mask; shapes
    ``[b, k]`` (a padding mask: any 2-D mask is read this way), ``[b, q,
    k]`` or ``[b, h, q, k]``."""
    m = torch.as_tensor(attn_mask)
    if not m.is_floating_point():
        m = torch.where(m != 0, 0.0, torch.finfo(torch.float32).min)
    m = m.float()
    if m.shape[-1] != seqlen:
        raise ValueError(f"attn_mask last dim {m.shape[-1]} != seqlen "
                         f"{seqlen}")
    if m.dim() == 2:
        m = m[:, None, None, :]
    elif m.dim() == 3:
        m = m[:, None, :, :]
    return m


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin, position_offset=0):
    """q, k ``[B, S, H, D]``; cos/sin ``[P, D]``. ``position_offset`` is
    an int (dense decoding) or a per-row ``[B]`` tensor (continuous
    batching: row b's chunk starts at ``position_offset[b]``).

    As in the JAX package, a bf16 q times the f32 tables promotes to
    f32, and the sum is cast back to q's dtype once."""
    s = q.shape[1]
    if isinstance(position_offset, torch.Tensor) and position_offset.dim():
        idx = (position_offset.long()[:, None]
               + torch.arange(s, device=q.device)[None, :])
        # padded bucket rows may run past the table; they are masked
        # garbage, so clamping (as a JAX gather does) is harmless
        idx = idx.clamp(max=cos.shape[0] - 1)
        c = cos[idx][:, :, None, :]                               # [B, S, 1, D]
        si = sin[idx][:, :, None, :]
    else:
        off = int(position_offset)
        c = cos[off:off + s][None, :, None, :]
        si = sin[off:off + s][None, :, None, :]
    q2 = q * c + _rotate_half(q) * si
    k2 = k * c + _rotate_half(k) * si
    return q2.to(q.dtype), k2.to(k.dtype)


class LlamaRMSNorm(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(config.hidden_size,
                                              device=device, dtype=dtype))
        self.eps = config.rms_norm_eps

    def forward(self, x):
        return F.rms_norm(x, self.weight, epsilon=self.eps)


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, rope, *, device, dtype):
        super().__init__()
        h, nh, nkv = (config.hidden_size, config.num_attention_heads,
                      config.num_key_value_heads)
        self.head_dim = h // nh
        self.num_heads = nh
        self.num_kv_heads = nkv
        kw = dict(has_bias=False, device=device, dtype=dtype)
        self.q_proj = ColumnParallelLinear(h, nh * self.head_dim,
                                           gather_output=False, **kw)
        self.k_proj = ColumnParallelLinear(h, nkv * self.head_dim,
                                           gather_output=False, **kw)
        self.v_proj = ColumnParallelLinear(h, nkv * self.head_dim,
                                           gather_output=False, **kw)
        self.o_proj = RowParallelLinear(nh * self.head_dim, h,
                                        input_is_parallel=True, **kw)
        # one table pair shared by every layer, rebuilt on load
        self.register_buffer("rope_cos", rope[0], persistent=False)
        self.register_buffer("rope_sin", rope[1], persistent=False)

    def forward(self, x, attn_mask=None, position_offset=0, kv_cache=None):
        """With ``kv_cache``: returns ``(out, new_cache)``. Without:
        causal self-attention over the chunk, K/V kept at
        ``num_kv_heads`` (the kernels route query groups to them)."""
        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        q, k = apply_rotary_pos_emb(q, k, self.rope_cos, self.rope_sin,
                                    position_offset)
        if kv_cache is not None:
            from .generation import cached_attention

            out, new_cache = cached_attention(
                q, k, v, kv_cache, position_offset,
                kv_heads=self.num_kv_heads, head_dim=self.head_dim,
                out_dtype=x.dtype)
            return self.o_proj(out), new_cache
        if attn_mask is not None:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=_mask_to_bias(attn_mask, s),
                is_causal=True)
        else:
            out, _ = F.flash_attention(q, k, v, causal=True)
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        kw = dict(has_bias=False, device=device, dtype=dtype)
        self.gate_proj = ColumnParallelLinear(h, i, gather_output=False, **kw)
        self.up_proj = ColumnParallelLinear(h, i, gather_output=False, **kw)
        self.down_proj = RowParallelLinear(i, h, input_is_parallel=True, **kw)

    def forward(self, x):
        return self.down_proj(nn.functional.silu(self.gate_proj(x))
                              * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, rope, *, device, dtype):
        super().__init__()
        self.config = config
        self.input_layernorm = LlamaRMSNorm(config, device=device,
                                            dtype=dtype)
        self.self_attn = LlamaAttention(config, rope, device=device,
                                        dtype=dtype)
        self.post_attention_layernorm = LlamaRMSNorm(config, device=device,
                                                     dtype=dtype)
        self.mlp = LlamaMLP(config, device=device, dtype=dtype)

    def decode(self, x, kv_cache, position_offset):
        """Cache-aware step (no recompute: decoding has no backward):
        attention writes this chunk's K/V."""
        h, new_cache = self.self_attn(self.input_layernorm(x),
                                      position_offset=position_offset,
                                      kv_cache=kv_cache)
        x = x + h
        return x + self.mlp(self.post_attention_layernorm(x)), new_cache

    def _body(self, x, attn_mask=None):
        x = x + self.self_attn(self.input_layernorm(x), attn_mask=attn_mask)
        return x + self.mlp(self.post_attention_layernorm(x))

    def forward(self, x, attn_mask=None):
        if self.config.recompute:
            return recompute(self._body, x, attn_mask,
                             policy=self.config.recompute_granularity)
        return self._body(x, attn_mask)


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, *, device, dtype):
        super().__init__()
        self.config = config
        self.embed_tokens = VocabParallelEmbedding(
            config.vocab_size, config.hidden_size, device=device, dtype=dtype)
        rope = _rope_tables(config.hidden_size // config.num_attention_heads,
                            config.max_position_embeddings,
                            config.rope_theta, device)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, rope, device=device, dtype=dtype)
             for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config, device=device, dtype=dtype)

    def forward(self, input_ids, attn_mask=None, kv_caches=None,
                position_offset=0):
        """With ``kv_caches``: ``(hidden, new_caches)``; without: the
        final hidden states."""
        if kv_caches is not None and attn_mask is not None:
            raise NotImplementedError(
                "KV-cache decoding builds only the causal validity mask; "
                "padded-batch decoding (attn_mask) is not supported")
        x = self.embed_tokens(input_ids)
        if kv_caches is not None:
            new_caches = []
            for layer, cache in zip(self.layers, kv_caches):
                x, nc = layer.decode(x, cache, position_offset)
                new_caches.append(nc)
            return self.norm(x), new_caches
        for layer in self.layers:
            x = layer(x, attn_mask=attn_mask)
        return self.norm(x)


class LlamaLMHead(nn.Module):
    def __init__(self, config: LlamaConfig, embed_weight=None, *, device,
                 dtype):
        super().__init__()
        self._tied = config.tie_word_embeddings and embed_weight is not None
        self.weight = (embed_weight if self._tied else nn.Parameter(
            torch.empty(config.hidden_size, config.vocab_size,
                        device=device, dtype=dtype)))

    def forward(self, x):
        out = quantized_matmul(self, x)   # weight-only int8 serving
        if out is not None:
            return out
        return torch.matmul(x, self.weight.t() if self._tied else self.weight)


class LlamaForCausalLM(nn.Module):
    """Llama with random weights drawn from ``seed`` (normal with
    ``initializer_range``; norms at one) on ``device``, which defaults
    to the card and raises when there is none."""

    def __init__(self, config: LlamaConfig, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(config.dtype)
        self.config = config
        self.llama = LlamaModel(config, device=device, dtype=dtype)
        self.lm_head = LlamaLMHead(
            config, self.llama.embed_tokens.weight, device=device,
            dtype=dtype)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (ColumnParallelLinear,
                                  VocabParallelEmbedding)) or (
                        isinstance(m, LlamaLMHead) and not m._tied):
                    m.weight.normal_(0.0, config.initializer_range,
                                     generator=gen)

    def forward(self, input_ids, labels=None, attn_mask=None,
                kv_caches=None, position_offset=0, logits_rows=None):
        """With ``kv_caches``: ``(logits, caches)``; ``logits_rows``
        (``[B]`` row indices) then runs the LM head only on row b's
        position ``logits_rows[b]`` and the logits are ``[B, vocab]``.

        Without caches, as in the JAX package: ``logits`` when ``labels``
        is None, else ``(logits, loss)``, or ``(None, loss)`` with
        ``fused_head_loss``. ``labels`` align with ``input_ids`` (the
        caller shifts them); ``-100`` is ignored."""
        if kv_caches is not None:
            h, new_caches = self.llama(input_ids, kv_caches=kv_caches,
                                       position_offset=position_offset)
            if logits_rows is not None:
                h = h[torch.arange(h.shape[0], device=h.device),
                      logits_rows.long()]
            return self.lm_head(h), new_caches
        h = self.llama(input_ids, attn_mask=attn_mask)
        if labels is not None and self.config.fused_head_loss:
            return None, fused_head_cross_entropy(
                h, self.lm_head.weight, labels,
                transpose_weight=self.lm_head._tied)
        logits = self.lm_head(h)
        if labels is None:
            return logits
        return logits, causal_lm_loss(logits, labels)

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=0, top_p=1.0, eos_token_id=None, seed=0):
        """Autoregressive decoding with static per-layer KV buffers
        (``models/generation.generate_with_cache``)."""
        from .generation import generate_with_cache

        cfg = self.config
        return generate_with_cache(
            self, input_ids, num_layers=cfg.num_hidden_layers,
            kv_heads=cfg.num_key_value_heads,
            head_dim=cfg.hidden_size // cfg.num_attention_heads,
            max_positions=cfg.max_position_embeddings,
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, eos_token_id=eos_token_id, seed=seed)


def causal_lm_loss(logits, labels, ignore_index=-100):
    """LM cross-entropy: mean over the labels that are not
    ``ignore_index``, log-softmax in f32."""
    return F.cross_entropy(logits, labels, ignore_index=ignore_index,
                           reduction="mean")


def _chunk_nll_sum(hc, w, lc, ignore_index):
    logits = hc @ w                                   # working dtype
    lse = torch.logsumexp(logits.float(), dim=-1)
    safe = lc.clamp(0, logits.shape[-1] - 1)
    picked = logits.gather(-1, safe[:, None])[:, 0].float()
    return torch.where(lc != ignore_index, lse - picked,
                       torch.zeros_like(lse)).sum()


def fused_head_cross_entropy(h, weight, labels, ignore_index=-100, chunks=4,
                             transpose_weight=False):
    """LM head matmul + cross-entropy without the whole ``[b*s, vocab]``
    logits: the tokens split into ``chunks`` (padded with ignored rows
    when they do not divide), each chunk's logits and logsumexp computed
    under ``torch.utils.checkpoint``, so the backward recomputes them one
    chunk at a time. Equals ``causal_lm_loss(lm_head(h), labels)``."""
    from torch.utils.checkpoint import checkpoint

    w = weight.t() if transpose_weight else weight
    d = h.shape[-1]
    hv = h.reshape(-1, d)
    lbl = labels.reshape(-1).long()
    pad = (-hv.shape[0]) % chunks
    if pad:
        hv = torch.cat([hv, hv.new_zeros(pad, d)])
        lbl = torch.cat([lbl, lbl.new_full((pad,), ignore_index)])
    total = sum(checkpoint(_chunk_nll_sum, hc, w, lc, ignore_index,
                           use_reentrant=False)
                for hc, lc in zip(hv.chunk(chunks), lbl.chunk(chunks)))
    return total / (lbl != ignore_index).sum().clamp(min=1).float()


def llama_loss_fn(model, input_ids, labels):
    """``loss_fn`` for ``TrainStep``."""
    _, loss = model(input_ids, labels=labels)
    return loss
