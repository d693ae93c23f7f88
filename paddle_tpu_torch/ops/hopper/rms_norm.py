"""RMSNorm: the Hopper kernel K6 (forward), its plain version, and the
autograd Function that gives both a gradient.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas/rms_norm.py``
(``rms_norm_pallas`` -> ``_fwd`` -> ``_fwd_kernel``): per row
``out = x * rsqrt(mean(x^2) + eps) * w`` in f32, cast once to the input
dtype, with ``rstd`` kept in f32 ``[rows, 1]`` for the backward. The
backward (``_vjp_bwd``) is XLA code outside any ``pallas_call`` in the
JAX package, so it is plain PyTorch here, on both devices
(:func:`rms_norm_backward`).

The kernel is CUDA C++ for ``sm_90a`` (``paddle_tpu_torch/csrc/rms_norm.cu``),
compiled with ``nvcc`` into a shared library with a plain C interface on
first use and called through ``ctypes``; the source's header note says
how it works. What bounds it on an H100 is HBM bytes at the training
shape and the launch at the serving shape (8 rows), so the wrapper is
kept cheap: the argument types are set once, the stream is read as a
raw handle, the only allocations are the outputs, and one C call makes
the launch.

:func:`rms_norm_reference` is the plain PyTorch version for CPU tensors
and for the comparison on the card; :func:`rms_norm_cuda` launches the
kernel and never falls back. A raw kernel launch carries no autograd
history, so callers that need a gradient go through
:class:`RMSNormFunction`.
"""

import ctypes
import functools

import torch

from ._build import build_library, count_launch

MAX_WIDTH = 32768   # widest row the kernel takes (csrc/rms_norm.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def rms_norm_reference(x2d, w, eps):
    """Plain version: ``x2d [rows, h]``, ``w [h]`` -> (out in x2d's
    dtype, rstd f32 ``[rows, 1]``)."""
    x = x2d.float()
    r = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * r * w.float()).to(x2d.dtype), r


@functools.lru_cache(maxsize=None)
def _library():
    path, _ = build_library("rms_norm", ["rms_norm.cu"])
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rms_norm_launch.argtypes = [p] * 4 + [i] * 3 + [ctypes.c_float, i, p]
    lib.rms_norm_launch.restype = i
    return lib


def build() -> str:
    """Build (or reuse) the kernel library now; returns the compiler
    log ("" when an earlier build was reused)."""
    _, log = build_library("rms_norm", ["rms_norm.cu"])
    _library()
    return log


@functools.lru_cache(maxsize=None)
def _device(index):
    # one torch.device per card, kept: making it anew costs a microsecond
    # of the wrapper's few
    return torch.device("cuda", index)


def _check(x2d, w):
    """(rows, h, dtype code, device index) of inputs the kernel takes;
    raises ``ValueError`` on any other."""
    if x2d.dim() != 2 or w.dim() != 1 or w.shape[0] != x2d.shape[1]:
        raise ValueError(f"want x [rows, h] and w [h]; got "
                         f"{tuple(x2d.shape)} and {tuple(w.shape)}")
    rows, h = x2d.shape
    if not 1 <= h <= MAX_WIDTH:
        raise ValueError(f"width {h}: the kernel takes 1 to {MAX_WIDTH}")
    code = _DTYPE_CODES.get(x2d.dtype)
    if code is None or w.dtype != x2d.dtype:
        raise ValueError(f"x/w dtypes {x2d.dtype}/{w.dtype}: want one "
                         f"dtype of float32, bfloat16, float16")
    dev = x2d.get_device()
    if dev < 0 or w.get_device() != dev:
        raise ValueError("x and w must lie on one CUDA device")
    return rows, h, code, dev


def rms_norm_cuda(x2d, w, eps):
    """Launch kernel K6 on ``x2d [rows, h]`` and ``w [h]`` (CUDA tensors
    of one dtype: float32, bfloat16 or float16; ``1 <= h <= MAX_WIDTH``).
    Returns (out, rstd f32 ``[rows, 1]``). Raises ``ValueError`` on
    inputs the kernel does not take and ``RuntimeError`` when the launch
    fails. The C call launches on x's device (it sets and restores the
    current device itself)."""
    rows, h, code, dev = _check(x2d, w)
    x2d = x2d.contiguous()
    w = w.contiguous()
    out = torch.empty_like(x2d)
    rstd = torch.empty((rows, 1), device=_device(dev), dtype=torch.float32)
    if rows == 0:
        return out, rstd
    rc = _library().rms_norm_launch(
        x2d.data_ptr(), w.data_ptr(), out.data_ptr(), rstd.data_ptr(), rows,
        h, code, eps, dev, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"rms_norm kernel launch failed: CUDA error {rc}")
    count_launch(rms_norm_cuda, str(x2d.dtype))
    return out, rstd


rms_norm_cuda.launches = 0
rms_norm_cuda.launches_by_form = {}


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
