"""RMSNorm: the Hopper kernel K6 (forward), its plain version, and the
autograd Function that gives both a gradient.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas/rms_norm.py``
(``rms_norm_pallas`` -> ``_fwd`` -> ``_fwd_kernel``): per row
``out = x * rsqrt(mean(x^2) + eps) * w`` in f32, cast once to the input
dtype, with ``rstd`` kept in f32 ``[rows, 1]`` for the backward. The
backward (``_vjp_bwd``) is XLA code outside any ``pallas_call`` in the
JAX package, so it is plain PyTorch here, on both devices
(:func:`rms_norm_backward`).

The kernel is Triton: one row reduction and an elementwise scale, with
no matrix product. What bounds it on an H100 is HBM bytes (read x and
w, write out and rstd: about 2 bytes each way per element in bf16
against a handful of flops), so the design reads each row exactly once:
one program per row, the whole row in registers (``BLOCK`` is the next
power of two of the width, masked at the edge), f32 math, one store.

Triton is imported inside the function that builds the kernel, so the
module imports where Triton is missing. :func:`rms_norm_reference` is
the plain PyTorch version for CPU tensors and for the comparison on the
card; :func:`rms_norm_cuda` launches the kernel and never falls back.
A raw kernel launch carries no autograd history, so callers that need a
gradient go through :class:`RMSNormFunction`.
"""

import functools

import torch

MAX_WIDTH = 32768   # widest row one program holds in registers


def rms_norm_reference(x2d, w, eps):
    """Plain version: ``x2d [rows, h]``, ``w [h]`` -> (out in x2d's
    dtype, rstd f32 ``[rows, 1]``)."""
    x = x2d.float()
    r = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * r * w.float()).to(x2d.dtype), r


@functools.lru_cache(maxsize=None)
def _kernel():
    # the jitted body resolves `tl` through the module's globals, as
    # for a kernel defined at module level
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def rms_norm_fwd(x_ptr, w_ptr, o_ptr, r_ptr, x_stride, o_stride, h, eps,
                     BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        mask = cols < h
        x = tl.load(x_ptr + row * x_stride + cols, mask=mask,
                    other=0.0).to(tl.float32)
        r = tl.rsqrt(tl.sum(x * x, axis=0) / h + eps)
        w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        y = x * r * w
        tl.store(o_ptr + row * o_stride + cols,
                 y.to(o_ptr.dtype.element_ty), mask=mask)
        tl.store(r_ptr + row, r)

    return rms_norm_fwd


def rms_norm_cuda(x2d, w, eps):
    """Launch kernel K6 on ``x2d [rows, h]`` and ``w [h]`` (CUDA
    tensors). Returns (out, rstd f32 ``[rows, 1]``)."""
    if x2d.dim() != 2 or w.dim() != 1 or w.shape[0] != x2d.shape[1]:
        raise ValueError(f"want x [rows, h] and w [h]; got "
                         f"{tuple(x2d.shape)} and {tuple(w.shape)}")
    if not (x2d.is_cuda and w.device == x2d.device):
        raise ValueError("x and w must lie on one CUDA device")
    if not (x2d.is_floating_point() and w.is_floating_point()):
        raise ValueError("rms_norm takes floating-point tensors")
    rows, h = x2d.shape
    if h > MAX_WIDTH:
        raise ValueError(f"width {h} exceeds the kernel's {MAX_WIDTH}")
    x2d = x2d.contiguous()
    w = w.contiguous()
    out = torch.empty_like(x2d)
    rstd = torch.empty((rows, 1), device=x2d.device, dtype=torch.float32)
    if rows == 0:
        return out, rstd
    block = 1 << max(h - 1, 1).bit_length()
    with torch.cuda.device(x2d.device):
        _kernel()[(rows,)](x2d, w, out, rstd, x2d.stride(0), out.stride(0),
                           h, float(eps), BLOCK=block,
                           num_warps=min(16, max(4, block // 1024)))
    rms_norm_cuda.launches += 1
    return out, rstd


rms_norm_cuda.launches = 0


def rms_norm_backward(x2d, w, rstd, g):
    """Port of the JAX package's ``_vjp_bwd`` from the saved ``rstd``:
    ``dx = rstd*g*w - x*rstd^3*<g*w, x>/h`` and ``dw = sum_rows g*x*rstd``,
    in f32, cast to the input dtypes."""
    x = x2d.float()
    gw = g.float() * w.float()
    dot = (gw * x).sum(dim=-1, keepdim=True)
    dx = rstd * gw - x * rstd ** 3 * dot / x.shape[-1]
    dw = (g.float() * x * rstd).sum(dim=0)
    return dx.to(x2d.dtype), dw.to(w.dtype)


class RMSNormFunction(torch.autograd.Function):
    """RMSNorm over ``x2d [rows, h]`` with weight ``w [h]``: K6 forward
    on a CUDA tensor, the plain version on a CPU tensor, and
    :func:`rms_norm_backward` on both."""

    @staticmethod
    def forward(ctx, x2d, w, eps):
        fwd = rms_norm_cuda if x2d.is_cuda else rms_norm_reference
        out, rstd = fwd(x2d, w, eps)
        ctx.save_for_backward(x2d, w, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        x2d, w, rstd = ctx.saved_tensors
        dx, dw = rms_norm_backward(x2d, w, rstd, g)
        return dx, dw, None
