"""DiT, the diffusion transformer (port of ``models/dit.py``): patchify,
adaLN-zero blocks conditioned on (timestep, class), unpatchify.

Attention is bidirectional flash attention
(``nn.functional.flash_attention`` with ``causal=False``: kernels K1-K4
on the card). DiT-XL/2 (``DiTConfig()``: hidden 1152 over 16 heads) has
head_dim 72, which the kernels run zero-padded to 128
(``ops/hopper/flash_attention.py``). The amp boundary is the JAX
package's: activations are cast to the weights' dtype at the matmul
edges, and the timestep embedding is computed in f32 first. The
adaLN-zero projections and the final projection start at zero, as in
the JAX package. Parameter names and the ``[in, out]`` layout follow it
(``convert.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..framework.device import resolve_device, resolve_dtype
from ..framework.dtype import promote
from ..nn import functional as F
from ..nn.initializer import Constant, Normal, XavierUniform
from ..nn.layer.norm import LayerNorm


@dataclass
class DiTConfig:
    input_size: int = 32          # latent spatial size
    patch_size: int = 2
    in_channels: int = 4
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    dtype: str = "float32"

    @staticmethod
    def tiny(**kw):
        base = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=64,
                    depth=2, num_heads=4, num_classes=10)
        base.update(kw)
        return DiTConfig(**base)


def timestep_embedding(t, dim, max_period=10000):
    """``[cos(t f), sin(t f)]`` with ``f = exp(-log(max_period) i /
    half)``, in f32 whatever t's dtype."""
    half = dim // 2
    log_period = torch.log(torch.tensor(float(max_period)))
    freqs = torch.exp(-log_period * torch.arange(half, dtype=torch.float32)
                      / half).to(t.device)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _mm(a, b):
    """A raw product, its operands promoted as ``jnp`` promotes them."""
    return torch.matmul(*promote(a, b))


def modulate(x, shift, scale):
    return x * (1 + scale[:, None, :]) + shift[:, None, :]


def _param(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


class DiTBlock(nn.Module):
    def __init__(self, cfg: DiTConfig, *, device, dtype):
        super().__init__()
        h = cfg.hidden_size
        self.nh = cfg.num_heads
        self.hd = h // self.nh
        mlp_h = int(h * cfg.mlp_ratio)
        kw = dict(device=device, dtype=dtype)
        self.norm1 = LayerNorm(h, epsilon=1e-6, **kw)
        self.qkv = _param((h, 3 * h), **kw)
        self.proj = _param((h, h), **kw)
        self.norm2 = LayerNorm(h, epsilon=1e-6, **kw)
        self.fc1 = _param((h, mlp_h), **kw)
        self.fc2 = _param((mlp_h, h), **kw)
        # adaLN-zero: the conditioning -> 6 modulation vectors, zero at
        # the start
        self.ada = _param((h, 6 * h), **kw)

    def init_weights(self, gen):
        for p in (self.qkv, self.proj, self.fc1, self.fc2):
            XavierUniform()(p, gen)
        Constant(0.0)(self.ada)

    def forward(self, x, c):
        # SiLU and GELU are raw jax.nn calls in the JAX package, not its
        # named ops: amp leaves them alone
        mods = _mm(nn.functional.silu(c), self.ada)
        sh1, sc1, g1, sh2, sc2, g2 = mods.chunk(6, dim=-1)
        b, s, h = x.shape
        n = modulate(self.norm1(x), sh1, sc1)
        q, k, v = _mm(n, self.qkv).reshape(b, s, 3, self.nh,
                                           self.hd).unbind(2)
        att, _ = F.flash_attention(q, k, v, causal=False)
        x = x + g1[:, None, :] * _mm(att.reshape(b, s, h), self.proj)
        n = modulate(self.norm2(x), sh2, sc2)
        # jax.nn.gelu's default, the tanh form
        m = _mm(nn.functional.gelu(_mm(n, self.fc1), approximate="tanh"),
                self.fc2)
        return x + g2[:, None, :] * m


class DiT(nn.Module):
    """DiT with random weights drawn from ``seed`` as the JAX package
    draws them (XavierUniform for the block and patch matmuls,
    ``Normal(0, 0.02)`` for the embeddings, zero adaLN and final
    projections, LayerNorms at one and zero) on ``device``, which
    defaults to the card and raises when there is none."""

    def __init__(self, cfg: DiTConfig, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        dtype = resolve_dtype(cfg.dtype)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        p, h = cfg.patch_size, cfg.hidden_size
        num_patches = (cfg.input_size // p) ** 2
        self.x_embed = _param((cfg.in_channels * p * p, h), **kw)
        self.pos_embed = _param((num_patches, h), **kw)
        self.t_fc1 = _param((256, h), **kw)
        self.t_fc2 = _param((h, h), **kw)
        self.y_embed = _param((cfg.num_classes + 1, h), **kw)
        self.blocks = nn.ModuleList([DiTBlock(cfg, **kw)
                                     for _ in range(cfg.depth)])
        self.final_norm = LayerNorm(h, epsilon=1e-6, **kw)
        self.final_ada = _param((h, 2 * h), **kw)
        self.final_proj = _param((h, cfg.in_channels * p * p), **kw)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        XavierUniform()(self.x_embed, gen)
        for w in (self.pos_embed, self.t_fc1, self.t_fc2, self.y_embed):
            Normal(std=0.02)(w, gen)
        for blk in self.blocks:
            blk.init_weights(gen)
        Constant(0.0)(self.final_ada)
        Constant(0.0)(self.final_proj)

    def patchify(self, x):
        p = self.cfg.patch_size
        b, c, hh, ww = x.shape
        x = x.reshape(b, c, hh // p, p, ww // p, p)
        return x.permute(0, 2, 4, 3, 5, 1).reshape(
            b, (hh // p) * (ww // p), p * p * c)

    def unpatchify(self, x):
        p = self.cfg.patch_size
        c = self.cfg.in_channels
        b, n, _ = x.shape
        g = int(n ** 0.5)
        x = x.reshape(b, g, g, p, p, c)
        return x.permute(0, 5, 1, 3, 2, 4).reshape(b, c, g * p, g * p)

    def forward(self, x, t, y):
        """x ``[b, in_channels, input_size, input_size]`` latents, t
        ``[b]`` timesteps, y ``[b]`` class labels (``num_classes`` is the
        null class) -> the prediction, shaped as x, in the weights'
        dtype."""
        # the amp boundary: cast activations to the weights' dtype at the
        # matmul edges, or the f32 timestep embedding would promote the
        # whole network to f32 through the adaLN conditioning
        wdt = self.x_embed.dtype
        tokens = (_mm(self.patchify(x).to(wdt), self.x_embed)
                  + self.pos_embed[None])
        temb = timestep_embedding(t, 256).to(wdt)
        temb = _mm(nn.functional.silu(_mm(temb, self.t_fc1)), self.t_fc2)
        c = temb + self.y_embed[y]
        h = tokens
        for blk in self.blocks:
            h = blk(h, c)
        sh, sc = _mm(nn.functional.silu(c), self.final_ada).chunk(2, dim=-1)
        out = _mm(modulate(self.final_norm(h), sh, sc), self.final_proj)
        return self.unpatchify(out)


def dit_loss_fn(model, x, t, y, noise_target):
    """The denoising MSE for ``TrainStep``: ``mean((model(x, t, y) -
    noise_target)^2)`` (a bf16 prediction against an f32 target is
    computed in f32)."""
    return torch.mean((model(x, t, y) - noise_target) ** 2)
