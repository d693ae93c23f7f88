"""BatchNorm statistics: the Hopper kernel K9, its plain version, and the
autograd Function around them.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas/bn_stats.py``
(``bn_stats`` -> ``_stats_fwd_impl`` -> ``_kernel``): per channel of a
channel-last ``[rows, c]`` activation, ``mean = sum(x) / rows`` and
``E[x^2] = sum(x^2) / rows``, accumulated in f32. The backward is the
closed form of ``_bwd`` (``dx = (g_mean + 2 x g_m2) / rows``), plain
PyTorch on both devices, as it is XLA code outside any ``pallas_call``
in the JAX package.

The kernel is CUDA C++ for ``sm_90a`` (``paddle_tpu_torch/csrc/bn_stats.cu``),
compiled with ``nvcc`` into a shared library with a plain C interface on
first use and called through ``ctypes``; the source's header note says
how it works. What bounds it on an H100 is HBM bytes (each bf16 element
is read once for two f32 adds). The TPU kernel carries its sums through
its sequential grid in VMEM; on Hopper the CTAs run in parallel, so each
CTA sums a strip of channels over a contiguous range of rows into one
f32 partial, and a second kernel, launched by the same C call, adds the
partials of each channel in a fixed order and scales them. No atomics:
two calls give equal bits. :func:`bn_stats_plan` mirrors the launch and
:func:`bn_stats_tiles_reference` models its summation order for the CPU
tests.

A CPU tensor runs :func:`bn_stats_reference`; a CUDA tensor launches the
kernel or raises, and never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import build_library

# csrc/bn_stats.cu: threads of a partial CTA, rows a slot loads at once,
# partial CTAs resident on an SM, warps of the final CTA
THREADS = 256
UNROLL = 4
CTAS_PER_SM = 4
FINAL_WARPS = 32
_DTYPE_CODES = {torch.bfloat16: 1, torch.float16: 2}


def supported(rows, c):
    """Shapes the JAX package sends to its kernel (copied)."""
    return c % 128 == 0 and rows % 8 == 0


def bn_stats_reference(x2d):
    """Plain version: ``x2d [rows, c]`` -> (mean, E[x^2]), f32 ``[c]``."""
    x = x2d.float()
    inv = 1.0 / x2d.shape[0]
    return x.sum(0) * inv, (x * x).sum(0) * inv


@functools.lru_cache(maxsize=256)
def bn_stats_plan(rows, c, sms):
    """K9's launch at one shape (bn_stats.cu's ``make_plan``): channel
    strips of ``strip`` (256 where c allows, else 128), ``slots`` rows a
    CTA loads at once (8 threads' 16-byte loads cover 64 channels), row
    groups of ``group`` rows (one step of every slot), ``parts`` CTAs
    along the rows, each owning ``rows_per_part`` contiguous rows (a
    whole number of groups; the last range is cut at ``rows``), about
    ``CTAS_PER_SM`` CTAs on each of ``sms`` SMs in all (``ctas``)."""
    strip = 256 if c % 256 == 0 else 128
    slots = THREADS // (strip // 8)
    group = slots * UNROLL
    strips = c // strip
    target = max(1, sms * CTAS_PER_SM // strips)
    per = -(-rows // target)
    rows_per_part = -(-per // group) * group
    parts = -(-rows // rows_per_part)
    return dict(strip=strip, slots=slots, group=group, strips=strips,
                rows_per_part=rows_per_part, parts=parts,
                ctas=parts * strips, final_warps=FINAL_WARPS)


def bn_stats_tiles_reference(x2d, plan):
    """K9 the kernels' way, in plain PyTorch f32, for the tests: per part,
    each row slot j adds the rows j, j + slots, ... of the part's range
    in order; the slots add in slot order into the part's partial; final
    warp w adds the partials w, w + final_warps, ... in order, the warps
    add in warp order, and the sums are scaled by 1 / rows. Same contract
    as :func:`bn_stats_reference`."""
    rows, c = x2d.shape
    x = x2d.float()
    slots, step = plan["slots"], plan["rows_per_part"]
    part = torch.zeros(plan["parts"], 2, c)
    for p in range(plan["parts"]):
        r0, r1 = p * step, min(rows, (p + 1) * step)
        acc = torch.zeros(2, slots, c)
        for r in range(r0, r1, slots):       # one row of every slot
            blk = x[r:min(r + slots, r1)]
            acc[0, :len(blk)] += blk
            acc[1, :len(blk)] += blk * blk
        for j in range(slots):
            part[p] += acc[:, j]
    warps = torch.zeros(plan["final_warps"], 2, c)
    for p in range(plan["parts"]):
        warps[p % plan["final_warps"]] += part[p]
    total = torch.zeros(2, c)
    for w in range(plan["final_warps"]):
        total += warps[w]
    inv = torch.tensor(1.0 / rows, dtype=torch.float32)
    return total[0] * inv, total[1] * inv


@functools.lru_cache(maxsize=None)
def _library():
    path, _ = build_library("bn_stats", ["bn_stats.cu"])
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bn_stats_launch.argtypes = [p] * 4 + [ctypes.c_longlong] + [i] * 4 \
        + [p]
    lib.bn_stats_launch.restype = i
    return lib


def build() -> str:
    """Build (or reuse) the kernel library now; returns the compiler
    log ("" when an earlier build was reused)."""
    _, log = build_library("bn_stats", ["bn_stats.cu"])
    _library()
    return log


@functools.lru_cache(maxsize=None)
def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@functools.lru_cache(maxsize=None)
def _device(index):
    # one torch.device per card, kept: making it anew costs a microsecond
    # of the wrapper's few
    return torch.device("cuda", index)


def _check(x2d):
    """(rows, c, dtype code, device index) of an input the kernel takes;
    raises ``ValueError`` on any other."""
    if x2d.dim() != 2:
        raise ValueError(f"want x [rows, c], got {tuple(x2d.shape)}")
    rows, c = x2d.shape
    if rows < 1 or c < 128 or c % 128:
        raise ValueError(f"shape {tuple(x2d.shape)}: the kernel takes rows "
                         f">= 1 and c % 128 == 0")
    code = _DTYPE_CODES.get(x2d.dtype)
    if code is None:
        raise ValueError(f"dtype {x2d.dtype}: the kernel takes bfloat16 and "
                         f"float16")
    dev = x2d.get_device()
    if dev < 0:
        raise ValueError(f"x must lie on a CUDA device, got {x2d.device}")
    if not x2d.is_contiguous() or x2d.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    return rows, c, code, dev


def bn_stats_cuda(x2d):
    """Launch K9 on ``x2d [rows, c]`` (a contiguous, 16-byte aligned
    bf16/f16 CUDA tensor with ``rows >= 1`` and ``c % 128 == 0``).
    Returns (mean, E[x^2]), f32 ``[c]``; both kernels of a call count as
    one launch. Raises ``ValueError`` on inputs the kernel does not take
    and ``RuntimeError`` when the launch fails. The C call launches on
    x's device (it sets and restores the current device itself)."""
    rows, c, code, dev = _check(x2d)
    sms = _sm_count(dev)
    parts = bn_stats_plan(rows, c, sms)["parts"]
    # one allocation: the partials [parts, 2, c], then (mean, E[x^2])
    buf = torch.empty((parts + 1, 2, c), device=_device(dev),
                      dtype=torch.float32)
    part_ptr = buf.data_ptr()
    mean_ptr = part_ptr + parts * 2 * c * 4
    rc = _library().bn_stats_launch(
        x2d.data_ptr(), part_ptr, mean_ptr, mean_ptr + 4 * c, rows, c, code,
        sms, dev, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"bn_stats kernel launch failed: CUDA error {rc}")
    bn_stats_cuda.launches += 1
    return buf[parts, 0], buf[parts, 1]


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
