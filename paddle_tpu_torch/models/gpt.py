"""GPT (port of ``models/gpt.py``): a decoder-only transformer with
learned positions, LayerNorm and a tanh-GELU MLP.

Without KV caches attention is causal flash attention
(``nn.functional.flash_attention``: kernels K1-K4 on the card, at head
dim 64 for GPT-2's geometry). With caches it goes through
``models.generation.cached_attention`` (kernel K5 for paged caches on
the card) and each row's ``position_offset`` indexes ``wpe``; with
``logits_rows`` the head runs on one row a sequence, so
``serving.paged_attention.paged_forward`` drives it as it drives Llama,
and ``ServingEngine.from_model`` reads the geometry from
``model.gpt.cfg``. After ``models.generation.quantize_for_decode`` the
qkv, out and MLP linears run the weight-only int8 product (kernel K10 on
the card); ``lm_head`` is a raw parameter, not a linear, and stays
dense, as in the JAX package.

Parameter names and Paddle's ``[in, out]`` layout follow the JAX
package, so its state dict loads by name (``convert.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..distributed.fleet.mpu import (ColumnParallelLinear, RowParallelLinear,
                                     VocabParallelEmbedding)
from ..framework.device import resolve_device, resolve_dtype
from ..framework.dtype import promote
from ..nn import functional as F
from ..nn.initializer import Normal
from ..nn.layer.norm import LayerNorm
from .llama import causal_lm_loss


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    dropout: float = 0.0
    dtype: str = "float32"

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    max_position_embeddings=64)
        base.update(kw)
        return GPTConfig(**base)


class GPTAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device, dtype):
        super().__init__()
        h = cfg.hidden_size
        self.nh = cfg.num_attention_heads
        self.hd = h // self.nh
        kw = dict(device=device, dtype=dtype)
        self.qkv_proj = ColumnParallelLinear(h, 3 * h, gather_output=False,
                                             **kw)
        self.out_proj = RowParallelLinear(h, h, input_is_parallel=True, **kw)

    def forward(self, x, position_offset=0, kv_cache=None):
        b, s, _ = x.shape
        q, k, v = self.qkv_proj(x).reshape(b, s, 3, self.nh,
                                           self.hd).unbind(2)
        if kv_cache is not None:
            from .generation import cached_attention

            out, new_cache = cached_attention(
                q, k, v, kv_cache, position_offset, kv_heads=self.nh,
                head_dim=self.hd, out_dtype=x.dtype)
            return self.out_proj(out), new_cache
        out, _ = F.flash_attention(q, k, v, causal=True)
        return self.out_proj(out.reshape(b, s, self.nh * self.hd))


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.ln_1 = LayerNorm(h, epsilon=cfg.layer_norm_epsilon, **kw)
        self.attn = GPTAttention(cfg, **kw)
        self.ln_2 = LayerNorm(h, epsilon=cfg.layer_norm_epsilon, **kw)
        self.fc_in = ColumnParallelLinear(h, cfg.intermediate_size,
                                          gather_output=False, **kw)
        self.fc_out = RowParallelLinear(cfg.intermediate_size, h,
                                        input_is_parallel=True, **kw)

    def _mlp_residual(self, x):
        # jax.nn.gelu's default, the tanh form; a raw call there, not
        # the named op (amp leaves it alone)
        return x + self.fc_out(nn.functional.gelu(
            self.fc_in(self.ln_2(x)), approximate="tanh"))

    def forward(self, x):
        return self._mlp_residual(x + self.attn(self.ln_1(x)))

    def decode(self, x, kv_cache, position_offset):
        h, new_cache = self.attn(self.ln_1(x),
                                 position_offset=position_offset,
                                 kv_cache=kv_cache)
        return self._mlp_residual(x + h), new_cache


class GPTModel(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.wte = VocabParallelEmbedding(cfg.vocab_size, cfg.hidden_size,
                                          **kw)
        self.wpe = nn.Parameter(torch.empty(
            cfg.max_position_embeddings, cfg.hidden_size, **kw))
        self.h = nn.ModuleList([GPTBlock(cfg, **kw)
                                for _ in range(cfg.num_hidden_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_epsilon,
                              **kw)

    def forward(self, input_ids, kv_caches=None, position_offset=0):
        """With ``kv_caches``: ``(hidden, new_caches)``; without: the
        final hidden states. ``position_offset`` is an int or, for
        continuous batching, a ``[B]`` tensor (row b's chunk starts at
        ``position_offset[b]``)."""
        s = input_ids.shape[1]
        x = self.wte(input_ids)
        if isinstance(position_offset, torch.Tensor) and \
                position_offset.dim():
            idx = (position_offset.long()[:, None]
                   + torch.arange(s, device=x.device)[None, :])
            # padded bucket rows may run past the table; they are masked
            # garbage, so clamping (as a JAX gather does) is harmless
            pe = self.wpe[idx.clamp(max=self.wpe.shape[0] - 1)]
        else:
            off = int(position_offset)
            pe = self.wpe[off:off + s][None]
        x = x + pe
        if kv_caches is not None:
            new_caches = []
            for blk, cache in zip(self.h, kv_caches):
                x, nc = blk.decode(x, cache, position_offset)
                new_caches.append(nc)
            return self.ln_f(x), new_caches
        for blk in self.h:
            x = blk(x)
        return self.ln_f(x)


class GPTForCausalLM(nn.Module):
    """GPT with random weights drawn from ``seed`` (``Normal(0,
    initializer_range)`` for every weight, embedding and linear bias, as
    the JAX package draws them; LayerNorms at one and zero) on
    ``device``, which defaults to the card and raises when there is
    none. The geometry is ``model.gpt.cfg``, as in the JAX package."""

    def __init__(self, cfg: GPTConfig, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(cfg.dtype)
        self.gpt = GPTModel(cfg, device=device, dtype=dtype)
        self.lm_head = nn.Parameter(torch.empty(
            cfg.hidden_size, cfg.vocab_size, device=device, dtype=dtype))
        gen = torch.Generator(device=device).manual_seed(int(seed))
        init = Normal(std=cfg.initializer_range)
        norms = {id(p) for m in self.modules() if isinstance(m, LayerNorm)
                 for p in m.parameters()}
        for p in self.parameters():
            if id(p) not in norms:
                init(p, gen)

    def forward(self, input_ids, labels=None, kv_caches=None,
                position_offset=0, logits_rows=None):
        """With ``kv_caches``: ``(logits, caches)``; ``logits_rows``
        (``[B]`` row indices) runs the head on row b's position
        ``logits_rows[b]`` only and the logits are ``[B, vocab]``.
        Without caches: ``logits``, or ``(logits, loss)`` with
        ``labels`` (aligned with ``input_ids``; ``-100`` ignored)."""
        if kv_caches is not None:
            h, new_caches = self.gpt(input_ids, kv_caches=kv_caches,
                                     position_offset=position_offset)
            if logits_rows is not None:
                h = h[torch.arange(h.shape[0], device=h.device),
                      logits_rows.long()]
            return torch.matmul(*promote(h, self.lm_head)), new_caches
        logits = torch.matmul(*promote(self.gpt(input_ids), self.lm_head))
        if labels is None:
            return logits
        return logits, causal_lm_loss(logits, labels)

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 top_k=0, top_p=1.0, eos_token_id=None, seed=0):
        """KV-cache decoding (``models/generation.generate_with_cache``)."""
        from .generation import generate_with_cache

        cfg = self.gpt.cfg
        return generate_with_cache(
            self, input_ids, num_layers=cfg.num_hidden_layers,
            kv_heads=cfg.num_attention_heads,
            head_dim=cfg.hidden_size // cfg.num_attention_heads,
            max_positions=cfg.max_position_embeddings,
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, eos_token_id=eos_token_id, seed=seed)
