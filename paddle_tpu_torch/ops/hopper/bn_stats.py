"""BatchNorm statistics: the Hopper kernel K9, its plain version, and the
autograd Function around them.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas/bn_stats.py``
(``bn_stats`` -> ``_stats_fwd_impl`` -> ``_kernel``): per channel of a
channel-last ``[rows, c]`` activation, ``mean = sum(x) / rows`` and
``E[x^2] = sum(x^2) / rows``, accumulated in f32. The backward is the
closed form of ``_bwd`` (``dx = (g_mean + 2 x g_m2) / rows``), plain
PyTorch on both devices, as it is XLA code outside any ``pallas_call``
in the JAX package.

The kernel is Triton: a column reduction with no product. What bounds it
on an H100 is HBM bytes (each bf16 element is read once for two f32
adds), so the design reads every element exactly once: a first program
grid sums blocks of 512 rows by 128 channels into f32 partials, a second
small grid adds the partials of each channel in a fixed order and
scales them (the TPU kernel carries the sums through its sequential grid
in VMEM; Hopper's programs run in parallel). Both stages are
deterministic: no atomics.

Triton is imported inside the function that builds the kernels, so the
module imports where Triton is missing. A CPU tensor runs
:func:`bn_stats_reference`; a CUDA tensor launches the kernel or raises,
and never falls back.
"""

from __future__ import annotations

import functools

import torch

ROWS_PER_PROGRAM = 512
BLOCK_ROWS = 32
BLOCK_C = 128
BLOCK_PARTS = 32


def supported(rows, c):
    """Shapes the JAX package sends to its kernel (copied)."""
    return c % 128 == 0 and rows % 8 == 0


def bn_stats_reference(x2d):
    """Plain version: ``x2d [rows, c]`` -> (mean, E[x^2]), f32 ``[c]``."""
    x = x2d.float()
    inv = 1.0 / x2d.shape[0]
    return x.sum(0) * inv, (x * x).sum(0) * inv


@functools.lru_cache(maxsize=None)
def _kernels():
    # the jitted bodies resolve `tl` through the module's globals, as for
    # kernels defined at module level
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def bn_stats_partial(x_ptr, part_ptr, rows, c,
                         ROWS_PER_PROG: tl.constexpr, BLOCK_R: tl.constexpr,
                         BLOCK: tl.constexpr):
        pr = tl.program_id(0)
        cols = tl.program_id(1) * BLOCK + tl.arange(0, BLOCK)
        cmask = cols < c
        acc1 = tl.zeros([BLOCK_R, BLOCK], tl.float32)
        acc2 = tl.zeros([BLOCK_R, BLOCK], tl.float32)
        r0 = pr * ROWS_PER_PROG
        for i in range(0, ROWS_PER_PROG, BLOCK_R):
            r = r0 + i + tl.arange(0, BLOCK_R)
            m = (r < rows)[:, None] & cmask[None, :]
            x = tl.load(x_ptr + r.to(tl.int64)[:, None] * c + cols[None, :],
                        mask=m, other=0.0).to(tl.float32)
            acc1 += x
            acc2 += x * x
        base = part_ptr + pr.to(tl.int64) * 2 * c
        tl.store(base + cols, tl.sum(acc1, axis=0), mask=cmask)
        tl.store(base + c + cols, tl.sum(acc2, axis=0), mask=cmask)

    @triton.jit
    def bn_stats_final(part_ptr, mean_ptr, m2_ptr, n_parts, c, inv_rows,
                       BLOCK_P: tl.constexpr, BLOCK: tl.constexpr):
        cols = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        cmask = cols < c
        acc1 = tl.zeros([BLOCK_P, BLOCK], tl.float32)
        acc2 = tl.zeros([BLOCK_P, BLOCK], tl.float32)
        for p0 in range(0, n_parts, BLOCK_P):
            p = p0 + tl.arange(0, BLOCK_P)
            m = (p < n_parts)[:, None] & cmask[None, :]
            at = p.to(tl.int64)[:, None] * 2 * c + cols[None, :]
            acc1 += tl.load(part_ptr + at, mask=m, other=0.0)
            acc2 += tl.load(part_ptr + at + c, mask=m, other=0.0)
        tl.store(mean_ptr + cols, tl.sum(acc1, axis=0) * inv_rows, mask=cmask)
        tl.store(m2_ptr + cols, tl.sum(acc2, axis=0) * inv_rows, mask=cmask)

    return bn_stats_partial, bn_stats_final


def bn_stats_cuda(x2d):
    """Launch K9 on ``x2d [rows, c]`` (a contiguous bf16/f16 CUDA tensor
    with ``c % 128 == 0``). Returns (mean, E[x^2]), f32 ``[c]``; both
    stages count as one launch."""
    if x2d.dim() != 2:
        raise ValueError(f"want x [rows, c], got {tuple(x2d.shape)}")
    if not x2d.is_cuda:
        raise ValueError(f"x must lie on a CUDA device, got {x2d.device}")
    if x2d.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"dtype {x2d.dtype}: the kernel takes bfloat16 and "
                         f"float16")
    if not x2d.is_contiguous():
        raise ValueError("x must be contiguous")
    rows, c = x2d.shape
    if rows < 1 or c % BLOCK_C:
        raise ValueError(f"shape {tuple(x2d.shape)}: the kernel takes rows "
                         f">= 1 and c % {BLOCK_C} == 0")
    n_parts = -(-rows // ROWS_PER_PROGRAM)
    dev = x2d.device
    part = torch.empty((n_parts, 2, c), device=dev, dtype=torch.float32)
    mean = torch.empty(c, device=dev, dtype=torch.float32)
    m2 = torch.empty(c, device=dev, dtype=torch.float32)
    partial, final = _kernels()
    with torch.cuda.device(dev):
        partial[(n_parts, c // BLOCK_C)](
            x2d, part, rows, c, ROWS_PER_PROG=ROWS_PER_PROGRAM,
            BLOCK_R=BLOCK_ROWS, BLOCK=BLOCK_C, num_warps=4)
        final[(c // BLOCK_C,)](part, mean, m2, n_parts, c, 1.0 / rows,
                               BLOCK_P=BLOCK_PARTS, BLOCK=BLOCK_C,
                               num_warps=4)
    bn_stats_cuda.launches += 1
    return mean, m2


bn_stats_cuda.launches = 0


def bn_stats_backward(x2d, g_mean, g_m2):
    """Port of the JAX package's ``_bwd``: ``dx = (g_mean + 2 x g_m2) /
    rows`` in f32, cast to x's dtype."""
    dx = (g_mean[None, :] + 2.0 * x2d.float() * g_m2[None, :]) \
        * (1.0 / x2d.shape[0])
    return dx.to(x2d.dtype)


class BNStatsFunction(torch.autograd.Function):
    """(mean, E[x^2]) over the rows of ``x2d [rows, c]``: K9 on a CUDA
    tensor, the plain version on a CPU tensor, and
    :func:`bn_stats_backward` on both."""

    @staticmethod
    def forward(ctx, x2d):
        x2d = x2d.contiguous()
        fwd = bn_stats_cuda if x2d.is_cuda else bn_stats_reference
        mean, m2 = fwd(x2d)
        ctx.save_for_backward(x2d)
        return mean, m2

    @staticmethod
    def backward(ctx, g_mean, g_m2):
        x2d, = ctx.saved_tensors
        return bn_stats_backward(x2d, g_mean, g_m2)


def bn_stats(x2d):
    """(mean[c], E[x^2][c]) in f32 over the rows of ``x2d [rows, c]``,
    differentiable."""
    return BNStatsFunction.apply(x2d)
