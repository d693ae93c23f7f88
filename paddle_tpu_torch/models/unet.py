"""The Stable-Diffusion UNet, the conditional denoiser of SD v1.5 (port of
``models/unet.py``): conv_in, down blocks (ResNet blocks, a spatial
transformer where ``attn_blocks`` says, a stride-2 conv), a middle
(ResNet, transformer, ResNet), up blocks over the skips concatenated
along the channels (nearest 2x upsampling, then a conv), then GroupNorm,
SiLU and conv_out; sinusoidal timestep embeddings and text conditioning
by cross-attention.

Attention goes through ``nn.functional.scaled_dot_product_attention``,
so through the flash kernels K1-K4 on the card: self-attention over the
``h * w`` positions and cross-attention against the context's tokens
(77 for SD v1.5's text encoder), both non-causal. As in the JAX package,
``attention_head_dim`` is the width of each head and the head count is
``channels // attention_head_dim``: SD v1.5 (``UNetConfig()``) runs 40,
80 and 160 heads of 8, which the kernels take zero-padded to 64
(``ops/hopper/flash_attention.py``). Convolutions, GroupNorm, LayerNorm,
GELU and SiLU are plain PyTorch, as the JAX package leaves them to XLA.

Without amp the model computes in the weights' dtype with no boundary,
as the JAX package's does: the f32 timestep embedding meets bf16 weights
at ``time_mlp1``, where PyTorch's matmul raises (the JAX package promotes
there and raises later, at a ResNet block's second conv), so only f32
trains. Under ``amp.auto_cast`` the named ops (convs, linears, norms,
SiLU, GELU, interpolate, attention, the timestep embedding and the
loss's subtract, multiply and mean) cast their inputs as the JAX
package's do, and the UNet trains in bf16 (O1 over f32 weights, or O2
after ``amp.decorate``). Parameter names are the JAX package's
(``conv_in.weight``, ``down_res_0_0.norm1.weight``,
``mid_attn.attn2.to_k.weight``, ...):
the block lists stay plain lists and each block is registered once
under its ``{list}_{block}_{layer}`` name. Linears keep Paddle's
``[in, out]`` weights and convs OIHW (``convert.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from ..framework.device import resolve_device
from ..nn import functional as F
from ..nn.layer import Conv2D, GroupNorm, LayerNorm, Linear, Silu
from ..ops.registry import named_op

# the tensor methods the JAX UNet and sd_loss_fn run as the JAX package's
# named ops, so that amp casts them as it does there (under O2, the
# prediction minus the f32 noise in the low dtype)
_subtract = named_op("subtract")(torch.sub)
_multiply = named_op("multiply")(torch.mul)
_mean = named_op("mean")(torch.mean)


@dataclass
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    sample_size: int = 64
    block_out_channels: tuple = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    attention_head_dim: int = 8
    norm_num_groups: int = 32
    # blocks with cross-attention (SD v1.5: all but the last down block)
    attn_blocks: tuple = (True, True, True, False)

    @staticmethod
    def sd15(**kw):
        return UNetConfig(**kw)

    @staticmethod
    def tiny(**kw):
        base = dict(block_out_channels=(32, 64), layers_per_block=1,
                    cross_attention_dim=32, attention_head_dim=4,
                    norm_num_groups=8, sample_size=16,
                    attn_blocks=(True, False))
        base.update(kw)
        return UNetConfig(**base)


@named_op("timestep_embedding")
def timestep_embedding(timesteps, dim, max_period=10000.0):
    """Sinusoidal embeddings ``[B, dim]``: ``[cos(t f), sin(t f)]`` with
    ``f = exp(-log(max_period) i / half)``, in f32 whatever t's dtype
    (diffusers' ``get_timestep_embedding``; DiT's own differs)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class ResnetBlock(nn.Module):
    def __init__(self, in_c, out_c, temb_c, groups, *, device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.norm1 = GroupNorm(groups, in_c, device=device)
        self.conv1 = Conv2D(in_c, out_c, 3, padding=1, **kw)
        self.time_emb_proj = Linear(temb_c, out_c, **kw)
        self.norm2 = GroupNorm(groups, out_c, device=device)
        self.conv2 = Conv2D(out_c, out_c, 3, padding=1, **kw)
        self.act = Silu()
        self.shortcut = (Conv2D(in_c, out_c, 1, **kw) if in_c != out_c
                         else None)

    def forward(self, x, temb):
        h = self.conv1(self.act(self.norm1(x)))
        h = h + self.time_emb_proj(self.act(temb))[:, :, None, None]
        h = self.conv2(self.act(self.norm2(h)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, query_dim, context_dim, heads, head_dim, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = Linear(query_dim, inner, bias_attr=False, **kw)
        self.to_k = Linear(context_dim, inner, bias_attr=False, **kw)
        self.to_v = Linear(context_dim, inner, bias_attr=False, **kw)
        self.to_out = Linear(inner, query_dim, **kw)

    def forward(self, x, context=None):
        context = x if context is None else context
        b, n, _ = x.shape
        m = context.shape[1]
        q = self.to_q(x).reshape(b, n, self.heads, self.head_dim)
        k = self.to_k(context).reshape(b, m, self.heads, self.head_dim)
        v = self.to_v(context).reshape(b, m, self.heads, self.head_dim)
        out = F.scaled_dot_product_attention(q, k, v)
        return self.to_out(out.reshape(b, n, self.heads * self.head_dim))


class TransformerBlock(nn.Module):
    """Spatial transformer: GroupNorm and a 1x1 conv in, self-attention,
    cross-attention and a GEGLU feed-forward over the ``[B, HW, C]``
    positions, a 1x1 conv out, plus the input."""

    def __init__(self, channels, context_dim, head_dim, groups, *, device,
                 generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        # the per-head width is head_dim; SD v1.5: 320 / 8 -> 40 heads
        heads = max(channels // head_dim, 1)
        self.norm_in = GroupNorm(groups, channels, device=device)
        self.proj_in = Conv2D(channels, channels, 1, **kw)
        self.norm1 = LayerNorm(channels, device=device)
        self.attn1 = CrossAttention(channels, channels, heads, head_dim, **kw)
        self.norm2 = LayerNorm(channels, device=device)
        self.attn2 = CrossAttention(channels, context_dim, heads, head_dim,
                                    **kw)
        self.norm3 = LayerNorm(channels, device=device)
        self.ff1 = Linear(channels, channels * 8, **kw)   # GEGLU: 2 x 4c
        self.ff2 = Linear(channels * 4, channels, **kw)
        self.proj_out = Conv2D(channels, channels, 1, **kw)

    def forward(self, x, context):
        b, c, h, w = x.shape
        residual = x
        y = self.proj_in(self.norm_in(x))
        y = y.reshape(b, c, h * w).transpose(1, 2)          # [B, HW, C]
        y = y + self.attn1(self.norm1(y))
        y = y + self.attn2(self.norm2(y), context)
        gate, val = self.ff1(self.norm3(y)).chunk(2, dim=-1)
        # the gate first, through the exact (erf) GELU, F.gelu's default
        y = y + self.ff2(_multiply(F.gelu(gate), val))
        y = y.transpose(1, 2).reshape(b, c, h, w)
        return residual + self.proj_out(y)


class Downsample(nn.Module):
    def __init__(self, channels, *, device, generator):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, stride=2, padding=1,
                           device=device, generator=generator)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels, *, device, generator):
        super().__init__()
        self.conv = Conv2D(channels, channels, 3, padding=1, device=device,
                           generator=generator)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class UNet2DConditionModel(nn.Module):
    """The UNet with random f32 weights drawn from ``seed`` by the JAX
    package's initialisers (KaimingUniform convs, XavierUniform linears,
    norms at one and zero) on ``device``, which defaults to the card and
    raises when there is none."""

    def __init__(self, config: UNetConfig | None = None, device=None,
                 seed=0, **kw):
        super().__init__()
        cfg = config or UNetConfig(**kw)
        self.config = cfg
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(int(seed))
        kw = dict(device=device, generator=gen)
        ch = cfg.block_out_channels
        temb_c = ch[0] * 4
        g = cfg.norm_num_groups
        head_dim = cfg.attention_head_dim

        def attn(channels):
            return TransformerBlock(channels, cfg.cross_attention_dim,
                                    head_dim, g, **kw)

        self.conv_in = Conv2D(cfg.in_channels, ch[0], 3, padding=1, **kw)
        self.time_proj_dim = ch[0]
        self.time_mlp1 = Linear(ch[0], temb_c, **kw)
        self.time_mlp2 = Linear(temb_c, temb_c, **kw)
        self.act = Silu()

        self.down_res, self.down_attn, self.down_sample = [], [], []
        in_c = ch[0]
        for bi, out_c in enumerate(ch):
            res_layers, attn_layers = [], []
            for _ in range(cfg.layers_per_block):
                res_layers.append(ResnetBlock(in_c, out_c, temb_c, g, **kw))
                attn_layers.append(attn(out_c) if cfg.attn_blocks[bi]
                                   else None)
                in_c = out_c
            self.down_res.append(res_layers)
            self.down_attn.append(attn_layers)
            self.down_sample.append(Downsample(out_c, **kw)
                                    if bi < len(ch) - 1 else None)
        self.mid_res1 = ResnetBlock(ch[-1], ch[-1], temb_c, g, **kw)
        self.mid_attn = attn(ch[-1])
        self.mid_res2 = ResnetBlock(ch[-1], ch[-1], temb_c, g, **kw)
        # up: the mirror, each ResNet block over a skip concatenated
        self.up_res, self.up_attn, self.up_sample = [], [], []
        skip_chs = self._skip_channels(ch, cfg.layers_per_block)
        for bi, out_c in enumerate(reversed(ch)):
            res_layers, attn_layers = [], []
            for _ in range(cfg.layers_per_block + 1):
                res_layers.append(ResnetBlock(in_c + skip_chs.pop(), out_c,
                                              temb_c, g, **kw))
                attn_layers.append(attn(out_c)
                                   if cfg.attn_blocks[len(ch) - 1 - bi]
                                   else None)
                in_c = out_c
            self.up_res.append(res_layers)
            self.up_attn.append(attn_layers)
            self.up_sample.append(Upsample(out_c, **kw)
                                  if bi < len(ch) - 1 else None)

        self.conv_norm_out = GroupNorm(g, ch[0], device=device)
        self.conv_out = Conv2D(ch[0], cfg.out_channels, 3, padding=1, **kw)
        self._register_lists()

    @staticmethod
    def _skip_channels(ch, layers_per_block):
        skips = [ch[0]]  # conv_in's output
        for bi, out_c in enumerate(ch):
            skips += [out_c] * layers_per_block
            if bi < len(ch) - 1:
                skips.append(out_c)   # the downsample's output
        return skips

    def _register_lists(self):
        for tag, blocks in (("down_res", self.down_res),
                            ("down_attn", self.down_attn),
                            ("up_res", self.up_res),
                            ("up_attn", self.up_attn)):
            for bi, layers in enumerate(blocks):
                for li, layer in enumerate(layers):
                    if layer is not None:
                        self.add_module(f"{tag}_{bi}_{li}", layer)
        for tag, layers in (("down_sample", self.down_sample),
                            ("up_sample", self.up_sample)):
            for bi, layer in enumerate(layers):
                if layer is not None:
                    self.add_module(f"{tag}_{bi}", layer)

    def forward(self, sample, timesteps, encoder_hidden_states):
        """sample ``[B, C, H, W]``; timesteps ``[B]``; the text context
        ``[B, L, D]``."""
        temb = timestep_embedding(timesteps, self.time_proj_dim)
        temb = self.time_mlp2(self.act(self.time_mlp1(temb)))

        h = self.conv_in(sample)
        skips = [h]
        for bi in range(len(self.down_res)):
            for res, attn in zip(self.down_res[bi], self.down_attn[bi]):
                h = res(h, temb)
                if attn is not None:
                    h = attn(h, encoder_hidden_states)
                skips.append(h)
            if self.down_sample[bi] is not None:
                h = self.down_sample[bi](h)
                skips.append(h)

        h = self.mid_res1(h, temb)
        h = self.mid_attn(h, encoder_hidden_states)
        h = self.mid_res2(h, temb)

        for bi in range(len(self.up_res)):
            for res, attn in zip(self.up_res[bi], self.up_attn[bi]):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if attn is not None:
                    h = attn(h, encoder_hidden_states)
            if self.up_sample[bi] is not None:
                h = self.up_sample[bi](h)

        return self.conv_out(self.act(self.conv_norm_out(h)))


def sd_loss_fn(model, latents, timesteps, context, noise):
    """The noise-prediction MSE (the DDPM epsilon objective), SD's
    training loss: the latents come noised (x_t) and the model predicts
    the noise."""
    diff = _subtract(model(latents, timesteps, context), noise)
    return _mean(_multiply(diff, diff))
