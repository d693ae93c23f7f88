"""Llama for serving (port of ``models/llama.py``: the KV-cache path).

The model runs RMSNorm (kernel K6 on the card), rotary embeddings,
GQA attention through ``models/generation.cached_attention`` (kernel K5
for paged caches on the card), and dense matmuls. Parameter names and
Paddle's ``[in, out]`` linear layout follow the JAX package, so its
state dict loads by name (``paddle_tpu_torch/convert.py``).

A forward WITHOUT KV caches runs the flash-attention kernels K1/K3 in
the JAX package. They port with the training slice; until then such a
forward raises ``NotImplementedError`` rather than running a plain
attention in their place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..distributed.fleet.mpu import (ColumnParallelLinear, RowParallelLinear,
                                     VocabParallelEmbedding)
from ..framework.device import resolve_device, resolve_dtype
from ..nn import functional as F

_NO_CACHE = ("a forward without KV caches runs flash attention (TPU kernels "
             "K1/K3), which ports with the training slice; pass kv_caches")


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

    def forward(self, x, position_offset=0, kv_cache=None):
        if kv_cache is None:
            raise NotImplementedError(_NO_CACHE)
        from .generation import cached_attention

        b, s, _ = x.shape
        q = self.q_proj(x).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).reshape(b, s, self.num_kv_heads, self.head_dim)
        q, k = apply_rotary_pos_emb(q, k, self.rope_cos, self.rope_sin,
                                    position_offset)
        out, new_cache = cached_attention(
            q, k, v, kv_cache, position_offset, kv_heads=self.num_kv_heads,
            head_dim=self.head_dim, out_dtype=x.dtype)
        return self.o_proj(out), new_cache


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
        self.input_layernorm = LlamaRMSNorm(config, device=device,
                                            dtype=dtype)
        self.self_attn = LlamaAttention(config, rope, device=device,
                                        dtype=dtype)
        self.post_attention_layernorm = LlamaRMSNorm(config, device=device,
                                                     dtype=dtype)
        self.mlp = LlamaMLP(config, device=device, dtype=dtype)

    def decode(self, x, kv_cache, position_offset):
        """Cache-aware step: attention writes this chunk's K/V."""
        h, new_cache = self.self_attn(self.input_layernorm(x),
                                      position_offset=position_offset,
                                      kv_cache=kv_cache)
        x = x + h
        return x + self.mlp(self.post_attention_layernorm(x)), new_cache


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

    def forward(self, input_ids, kv_caches=None, position_offset=0):
        if kv_caches is None:
            raise NotImplementedError(_NO_CACHE)
        x = self.embed_tokens(input_ids)
        new_caches = []
        for layer, cache in zip(self.layers, kv_caches):
            x, nc = layer.decode(x, cache, position_offset)
            new_caches.append(nc)
        return self.norm(x), new_caches


class LlamaLMHead(nn.Module):
    def __init__(self, config: LlamaConfig, embed_weight=None, *, device,
                 dtype):
        super().__init__()
        self._tied = config.tie_word_embeddings and embed_weight is not None
        self.weight = (embed_weight if self._tied else nn.Parameter(
            torch.empty(config.hidden_size, config.vocab_size,
                        device=device, dtype=dtype)))

    def forward(self, x):
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

    def forward(self, input_ids, kv_caches=None, position_offset=0,
                logits_rows=None):
        """Returns ``(logits, caches)``. With ``logits_rows`` (``[B]``
        row indices) the LM head runs only on row b's position
        ``logits_rows[b]`` and the logits are ``[B, vocab]``."""
        h, new_caches = self.llama(input_ids, kv_caches=kv_caches,
                                   position_offset=position_offset)
        if logits_rows is not None:
            h = h[torch.arange(h.shape[0], device=h.device),
                  logits_rows.long()]
        return self.lm_head(h), new_caches

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
