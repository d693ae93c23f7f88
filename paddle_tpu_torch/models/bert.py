"""BERT (port of ``models/bert.py``): a post-LN encoder with an MLM head
for pretraining.

Attention is bidirectional flash attention
(``nn.functional.flash_attention`` with ``causal=False``: kernels K1-K4
on the card, at head dim 64 for BERT-base). The MLM head maps negative
labels to ``-100`` (ignored). With ``fused_head_loss`` the head and the
cross-entropy run in token chunks (``models.llama.fused_head_cross_entropy``)
and the forward returns ``(None, loss)``; without it, ``(logits, loss)``
from ``causal_lm_loss``. Parameter names and Paddle's ``[in, out]``
layout follow the JAX package (``convert.py``).
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
from .llama import causal_lm_loss, fused_head_cross_entropy


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    # chunked MLM head + cross-entropy: the [b, s, vocab] logits are never
    # whole, and the forward returns (None, loss)
    fused_head_loss: bool = False
    dtype: str = "float32"

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    max_position_embeddings=64)
        base.update(kw)
        return BertConfig(**base)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, *, device, dtype):
        super().__init__()
        h = cfg.hidden_size
        self.nh = cfg.num_attention_heads
        self.hd = h // self.nh
        kw = dict(device=device, dtype=dtype)
        self.qkv = ColumnParallelLinear(h, 3 * h, gather_output=False, **kw)
        self.attn_out = RowParallelLinear(h, h, input_is_parallel=True, **kw)
        self.attn_ln = LayerNorm(h, epsilon=cfg.layer_norm_eps, **kw)
        self.ffn_in = ColumnParallelLinear(h, cfg.intermediate_size,
                                           gather_output=False, **kw)
        self.ffn_out = RowParallelLinear(cfg.intermediate_size, h,
                                         input_is_parallel=True, **kw)
        self.ffn_ln = LayerNorm(h, epsilon=cfg.layer_norm_eps, **kw)

    def forward(self, x):
        b, s, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, s, 3, self.nh, self.hd).unbind(2)
        out, _ = F.flash_attention(q, k, v, causal=False)
        x = self.attn_ln(x + self.attn_out(out.reshape(b, s, -1)))
        # jax.nn.gelu's default, the tanh form; a raw call there, not
        # the named op (amp leaves it alone)
        m = self.ffn_out(nn.functional.gelu(self.ffn_in(x),
                                            approximate="tanh"))
        return self.ffn_ln(x + m)


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        h = cfg.hidden_size
        self.word_embeddings = VocabParallelEmbedding(cfg.vocab_size, h, **kw)
        self.position_embeddings = nn.Parameter(torch.empty(
            cfg.max_position_embeddings, h, **kw))
        self.token_type_embeddings = nn.Parameter(torch.empty(
            cfg.type_vocab_size, h, **kw))
        self.emb_ln = LayerNorm(h, epsilon=cfg.layer_norm_eps, **kw)
        self.encoder = nn.ModuleList([BertLayer(cfg, **kw)
                                      for _ in range(cfg.num_hidden_layers)])

    def forward(self, input_ids, token_type_ids=None):
        s = input_ids.shape[1]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings[None, :s])
        if token_type_ids is not None:
            x = x + self.token_type_embeddings[token_type_ids]
        x = self.emb_ln(x)
        for layer in self.encoder:
            x = layer(x)
        return x


def _mlm_labels(labels):
    """Negative labels mean "not masked": ignored as -100."""
    return torch.where(labels < 0, torch.full_like(labels, -100), labels)


class BertForPretraining(nn.Module):
    """BERT with random weights drawn from ``seed`` (``Normal(0,
    initializer_range)`` for every weight, embedding and linear bias, as
    the JAX package draws them; LayerNorms at one and zero) on
    ``device``, which defaults to the card and raises when there is
    none."""

    def __init__(self, cfg: BertConfig, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(cfg.dtype)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.bert = BertModel(cfg, **kw)
        self.mlm_transform = ColumnParallelLinear(cfg.hidden_size,
                                                  cfg.hidden_size, **kw)
        self.mlm_ln = LayerNorm(cfg.hidden_size, epsilon=cfg.layer_norm_eps,
                                **kw)
        self.decoder = nn.Parameter(torch.empty(
            cfg.hidden_size, cfg.vocab_size, **kw))
        gen = torch.Generator(device=device).manual_seed(int(seed))
        init = Normal(std=cfg.initializer_range)
        norms = {id(p) for m in self.modules() if isinstance(m, LayerNorm)
                 for p in m.parameters()}
        for p in self.parameters():
            if id(p) not in norms:
                init(p, gen)

    def forward(self, input_ids, labels=None, token_type_ids=None):
        """``logits`` without ``labels``; with them ``(logits, loss)``,
        or ``(None, loss)`` with ``fused_head_loss``. Labels below zero
        are ignored."""
        h = self.bert(input_ids, token_type_ids)
        t = self.mlm_ln(nn.functional.gelu(self.mlm_transform(h),
                                           approximate="tanh"))
        if labels is not None and self.cfg.fused_head_loss:
            return None, fused_head_cross_entropy(
                t, self.decoder, _mlm_labels(labels), ignore_index=-100)
        logits = torch.matmul(*promote(t, self.decoder))
        if labels is None:
            return logits
        return logits, causal_lm_loss(logits, _mlm_labels(labels),
                                      ignore_index=-100)
