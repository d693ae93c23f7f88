"""Weight-only int8 matmul: the Hopper kernel K10 and its plain version.

``out = (x @ q) * s`` with ``q`` int8 ``[K, N]`` (Paddle's ``[in, out]``
layout) and ``s`` the f32 per-output-channel scale that
``models.generation.quantize_for_decode`` gives every quantized linear.
It replaces no ``pl.pallas_call``: the JAX package writes
``(x @ convert(q)) * s`` (``paddle_tpu/distributed/fleet/mpu.py:132``,
``_int8_matmul``; the LM head at ``paddle_tpu/models/llama.py:328``) and
XLA fuses the convert into the dot, so the int8 bytes stream through it.
PyTorch has no such fusion: ``x @ q.to(bf16)`` writes a dense bf16 copy
of every weight and reads it back (about 5 bytes a weight against the
dense model's 2), so the port's counterpart is a kernel that reads the
int8 bytes once and converts them in registers.

The kernel is CUDA C++ for ``sm_90a``
(``paddle_tpu_torch/csrc/int8_matmul.cu``, whose header note gives the
design), built with ``nvcc`` on first use and called through ``ctypes``.
It takes bf16 activations (serving) and f32 ones (the f32 parity
checks). What bounds it on an H100 is HBM bytes:
decode reads every weight once.

:func:`int8_matmul_plain` is the plain PyTorch version, for CPU tensors
and for the comparison on the card; :func:`int8_matmul_cuda` launches the
kernel and never falls back; :func:`int8_matmul` picks by the tensor's
device. No autograd: a quantized model serves only.
"""

import ctypes
import functools
import math

import torch

from ._build import build_library, count_launch

SOURCES = ["int8_matmul.cu"]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# tiles of the two bodies (csrc/int8_matmul.cu): bf16 BN x BK with BM = 16
# or 64 rows, f32 64 x 64 outputs over 16-row K stages
BF16_BN, BF16_BK = 128, 64
F32_BM, F32_BN, F32_BK = 64, 64, 16
H100_SMS = 132


def int8_matmul_plain(x, q, s):
    """Plain version: ``(x @ q.to(x.dtype)) * s.to(x.dtype)``, the JAX
    package's ``_int8_matmul`` formula. ``x [..., K]``, ``q`` int8
    ``[K, N]``, ``s`` f32 ``[1, N]`` or ``[N]``."""
    return (x @ q.to(x.dtype)) * s.to(x.dtype)


@functools.lru_cache(maxsize=4096)
def int8_matmul_plan(m, n, k, dtype, sms=H100_SMS):
    """The launch of :func:`int8_matmul_cuda` for ``x [m, k]`` of
    ``dtype`` and ``q [k, n]``: the bf16 body's row tiles of 16 (``mi``:
    1 up to 16 rows, else 4), the tile sizes, and the split of K over
    ``splits`` CTAs of ``per`` K stages each. K is split only where the
    output tiles do not fill the card's ``sms`` SMs, into at most two
    CTAs an SM and at least 4 stages a split. Cached: the wrapper asks
    once a shape (callers do not change the returned dict)."""
    if dtype == torch.bfloat16:
        mi = 1 if m <= 16 else 4
        bm, bn, bk = 16 * mi, BF16_BN, BF16_BK
    else:
        mi, bm, bn, bk = 1, F32_BM, F32_BN, F32_BK
    tiles = math.ceil(n / bn) * math.ceil(m / bm)
    stages = math.ceil(k / bk)
    splits = 1
    if tiles < sms:
        splits = max(1, min(math.ceil(2 * sms / tiles), stages // 4))
    per = math.ceil(stages / splits)
    splits = math.ceil(stages / per)
    return dict(mi=mi, bm=bm, bn=bn, bk=bk, tiles=tiles, splits=splits,
                per=per)


@functools.lru_cache(maxsize=None)
def _library():
    path, _ = build_library("int8_matmul", SOURCES)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int8_matmul_launch.argtypes = [p] * 5 + [i] * 8 + [p]
    lib.int8_matmul_launch.restype = i
    return lib


def build() -> str:
    """Build (or reuse) the kernel library now; returns the compiler
    log ("" when an earlier build was reused)."""
    _, log = build_library("int8_matmul", SOURCES)
    _library()
    return log


@functools.lru_cache(maxsize=None)
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x, q, s):
    """(x as a contiguous [M, K], N, dtype code, device index) of inputs
    the kernel takes; raises ``ValueError`` on any other."""
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise ValueError(f"x dtype {x.dtype}: the kernel takes float32 or "
                         f"bfloat16 activations")
    if q.dtype != torch.int8 or q.dim() != 2:
        raise ValueError(f"want q int8 [K, N]; got {q.dtype} "
                         f"{tuple(q.shape)}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous ([K, N], N fastest)")
    k, n = q.shape
    if x.shape[-1] != k:
        raise ValueError(f"x's last dim {x.shape[-1]} != q's K {k}")
    if n % 16 or k % 8:
        raise ValueError(f"q [{k}, {n}]: the kernel takes N % 16 == 0 and "
                         f"K % 8 == 0")
    if s.dtype != torch.float32 or s.numel() != n or not s.is_contiguous():
        raise ValueError(f"want s float32 with {n} contiguous elements; got "
                         f"{s.dtype} {tuple(s.shape)}")
    dev = x.get_device()
    if dev < 0 or q.get_device() != dev or s.get_device() != dev:
        raise ValueError("x, q and s must lie on one CUDA device")
    x2 = x.reshape(-1, k).contiguous()
    for t in (x2, q, s):
        if t.data_ptr() % 16:
            raise ValueError("every operand must start 16-byte aligned")
    return x2, n, code, dev


def int8_matmul_cuda(x, q, s):
    """Launch kernel K10: ``x [..., K]`` (float32 or bfloat16, CUDA),
    ``q`` int8 ``[K, N]`` contiguous, ``s`` float32 with ``N`` elements;
    ``N % 16 == 0`` and ``K % 8 == 0``. Returns ``[..., N]`` in x's
    dtype. Raises ``ValueError`` on inputs the kernel does not take and
    ``RuntimeError`` when the launch fails."""
    x2, n, code, dev = _check(x, q, s)
    m, k = x2.shape
    out = torch.empty((m, n), device=x2.device, dtype=x2.dtype)
    if m == 0:
        return out.reshape(*x.shape[:-1], n)
    plan = int8_matmul_plan(m, n, k, x2.dtype, _sms(dev))
    ws = (torch.empty((plan["splits"], m, n), device=x2.device,
                      dtype=torch.float32) if plan["splits"] > 1 else None)
    rc = _library().int8_matmul_launch(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        0 if ws is None else ws.data_ptr(), m, n, k, code, plan["mi"],
        plan["splits"], plan["per"], dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    count_launch(int8_matmul_cuda)
    return out.reshape(*x.shape[:-1], n)


int8_matmul_cuda.launches = 0


def int8_matmul(x, q, s):
    """``(x @ q) * s``: kernel K10 on a CUDA tensor, the plain version on
    a CPU tensor."""
    return (int8_matmul_cuda if x.is_cuda else int8_matmul_plain)(x, q, s)
