"""Common functions (port of ``nn/functional/common.py``: ``linear``,
``interpolate`` and ``upsample``), ``linear`` and ``interpolate`` as the
JAX package's ops of those names (``ops/registry.py``)."""

from __future__ import annotations

import numpy as np
import torch

from ...ops.registry import named_op


@named_op("linear")
def linear(x, weight, bias=None):
    """``x @ weight (+ bias)`` with Paddle's ``[in, out]`` weight; the
    product is rounded to the input dtype before the bias is added, as
    in the JAX package."""
    out = x @ weight
    return out if bias is None else out + bias


def _interp_axis_weights(in_sz, out_sz, mode, align):
    """Dense ``[out, in]`` linear or cubic interpolation matrix for one
    axis, with the reference's coordinate conventions (those of Paddle's
    and torch's interpolate kernels): half-pixel centres unless
    ``align``; cubic convolution with A = -0.75; taps past an edge clamp
    to it."""
    i = np.arange(out_sz, dtype=np.float64)
    w = np.zeros((out_sz, in_sz), np.float32)
    if align and out_sz > 1:
        x = i * (in_sz - 1) / (out_sz - 1)
    else:
        x = (i + 0.5) * in_sz / out_sz - 0.5
    x0 = np.floor(x)
    if mode == "linear":
        frac = x - x0
        taps = ((x0, 1 - frac), (x0 + 1, frac))
    else:
        a = -0.75

        def cub(t):
            t = np.abs(t)
            return np.where(
                t <= 1, (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
                np.where(t < 2, a * t ** 3 - 5 * a * t ** 2 + 8 * a * t
                         - 4 * a, 0.0))
        taps = [(x0 + k, cub(x - (x0 + k))) for k in range(-1, 3)]
    for tap, wgt in taps:
        idx = np.clip(tap.astype(int), 0, in_sz - 1)
        np.add.at(w, (np.arange(out_sz), idx), wgt.astype(np.float32))
    return w


def _nearest_source(in_sz, out_sz, align):
    """The input index each output index of a nearest resize reads:
    ``floor(i * in / out)``, or with ``align`` ``i * (in - 1) / (out -
    1)`` rounded half up."""
    i = np.arange(out_sz, dtype=np.float64)
    if align and out_sz > 1:
        src = np.floor(i * (in_sz - 1) / (out_sz - 1) + 0.5)
    else:
        src = np.floor(i * in_sz / out_sz)
    return np.clip(src.astype(int), 0, in_sz - 1)


def _area_weights(in_sz, out_sz):
    """``[out, in]`` bin averages of adaptive average pooling."""
    w = np.zeros((out_sz, in_sz), np.float32)
    for o in range(out_sz):
        lo = int(np.floor(o * in_sz / out_sz))
        hi = int(np.ceil((o + 1) * in_sz / out_sz))
        w[o, lo:hi] = 1.0 / (hi - lo)
    return w


_MODES = {"nearest": "nearest", "linear": "linear", "bilinear": "linear",
          "trilinear": "linear", "bicubic": "cubic", "area": "area"}


@named_op("interpolate")
def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """Resize the spatial axes of ``x`` (channels second, or last when
    ``data_format`` ends in ``C``) to ``size`` or ``int(in *
    scale_factor)``, one axis after another, as the JAX body does: each
    axis is a product with its ``[out, in]`` weights in f32, cast back to
    x's dtype before the next axis; an axis whose size stays is skipped.
    ``area`` averages adaptive-pooling bins over every axis, its product
    in the promoted dtype of x and f32 (f32 for a bf16 input) and not
    cast back, as in the JAX body. ``nearest`` gathers the rows its
    one-hot weights would pick: the same values for finite inputs, with
    no product."""
    kind = _MODES[mode]
    channel_last = data_format.endswith("C") and len(data_format) > 2
    sp0 = 1 if channel_last else 2
    n_sp = x.dim() - 2
    spatial = list(x.shape[sp0:sp0 + n_sp])
    if size is not None:
        new = [int(s) for s in (size if isinstance(size, (list, tuple))
                                else [size])]
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * n_sp)
        new = [int(s * f) for s, f in zip(spatial, sf)]
    out = x
    for ax, (in_sz, out_sz) in enumerate(zip(spatial, new)):
        dim = sp0 + ax
        if kind == "area":
            w = torch.from_numpy(_area_weights(in_sz, out_sz)).to(out.device)
            dt = torch.promote_types(out.dtype, torch.float32)
            out = (out.movedim(dim, -1).to(dt) @ w.to(dt).T).movedim(-1, dim)
            continue
        if in_sz == out_sz:
            continue
        if kind == "nearest":
            src = _nearest_source(in_sz, out_sz, align_corners)
            out = out.index_select(dim, torch.from_numpy(src).to(out.device))
            continue
        w = torch.from_numpy(_interp_axis_weights(in_sz, out_sz, kind,
                                                  align_corners))
        moved = out.movedim(dim, -1).float()
        out = (moved @ w.to(out.device).T).to(x.dtype).movedim(-1, dim)
    return out


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, data_format="NCHW"):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       data_format)
