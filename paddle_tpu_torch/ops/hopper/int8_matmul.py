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
checks). What bounds it on an H100: at decode (up to 16 rows) the int8
bytes of the weight, which every call reads once; at a 512-row prefill
chunk the operations, and the loads of x from L2 that feed them. One
body serves every row count in bf16: the product runs as
``out^T = q^T x^T`` on ``wgmma``, the weight tile converted in registers
as its A operand and x from shared memory as its B (TMA, mbarriers, a
producer warp or warpgroup), so the token rows are ``wgmma``'s N (8 to
128 a tile). Where the tiles do not fill the card, K is split over the
CTAs of a thread-block cluster, which add their partial sums through
shared memory in split order: one launch a call, no workspace, equal
bits on every call. :func:`int8_matmul_plan` gives the launch (row tile,
warpgroups, split; the rule was chosen by timing every split on the card,
``chip_smoke.py --int8-kernel``) and packs it into the one ``int`` the C
call takes. The tensor map of each weight is kept by the C side, so a
call encodes only x's; a call costs about as much host time as
``torch.matmul``'s.

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
# tiles of the two bodies (csrc/int8_matmul.cu). bf16: BM token rows
# (wgmma's N, the least of ROW_TILES that holds the rows, else the last),
# 128 weight columns a consumer warpgroup (1 a CTA below 64 rows, else 2),
# 64 of K a stage, K split over at most 8 CTAs of a cluster into at least
# 4 stages each. f32: 64 x 64 outputs over 16-row K stages, no split.
ROW_TILES = (8, 16, 32, 64, 128)
BF16_COLS, BF16_BK, MAX_SPLITS, MIN_STAGES = 128, 64, 8, 4
F32_BM, F32_BN, F32_BK = 64, 64, 16
H100_SMS = 132


def int8_matmul_plain(x, q, s):
    """Plain version: ``(x @ q.to(x.dtype)) * s.to(x.dtype)``, the JAX
    package's ``_int8_matmul`` formula. ``x [..., K]``, ``q`` int8
    ``[K, N]``, ``s`` f32 ``[1, N]`` or ``[N]``."""
    return (x @ q.to(x.dtype)) * s.to(x.dtype)


def plan_code(per, splits, bm, dtype_code):
    """The launch as the C call's one ``plan`` int: bits 0-11 ``per``,
    12-15 ``splits``, 16-23 ``bm``, 28 the dtype code."""
    return per | splits << 12 | bm << 16 | dtype_code << 28


@functools.lru_cache(maxsize=4096)
def int8_matmul_plan(m, n, k, dtype, sms=H100_SMS):
    """The launch of :func:`int8_matmul_cuda` for ``x [m, k]`` of
    ``dtype`` and ``q [k, n]``. bf16: the row tile ``bm``, ``wg``
    consumer warpgroups of 128 columns a CTA, the ``tiles`` of ``bm`` x
    ``bn`` outputs, and the split of K into ``splits`` CTAs (a cluster)
    of ``per`` stages of 64, each at least 4 (csrc/int8_matmul.cu
    ``Cfg``). Decode tiles (``bm`` < 64) take 1 warpgroup and 3 CTAs an
    SM, and the split doubles while the CTAs fit on the card at once, up
    to 8. Prefill tiles take 2 warpgroups (each stage of x then serves
    256 columns) and 1 CTA an SM, and the split doubles while the CTAs
    fit in one wave, up to 4: a cluster of 8 such CTAs needs 8 free SMs
    of one GPC. f32: 64 x 64 tiles and no
    split. ``code`` packs it for the C call (:func:`plan_code`). Cached:
    the wrapper asks once a shape (callers do not change the returned
    dict)."""
    if dtype != torch.bfloat16:
        stages = math.ceil(k / F32_BK)
        return dict(body="f32", bm=F32_BM, bn=F32_BN, bk=F32_BK, wg=0,
                    tiles=math.ceil(n / F32_BN) * math.ceil(m / F32_BM),
                    stages=stages, splits=1, per=stages,
                    code=plan_code(0, 1, 0, _DTYPE_CODES[torch.float32]))
    bm = next((b for b in ROW_TILES if m <= b), ROW_TILES[-1])
    wg, ctas, most = (1, 3, MAX_SPLITS) if bm < 64 else (2, 1, MAX_SPLITS // 2)
    bn = wg * BF16_COLS
    tiles = math.ceil(m / bm) * math.ceil(n / bn)
    slots = sms * ctas
    stages = math.ceil(k / BF16_BK)
    splits = 1
    while (2 * splits <= most and 2 * splits * tiles <= slots
           and stages >= 2 * splits * MIN_STAGES):
        splits *= 2
    per = math.ceil(stages / splits)
    splits = math.ceil(stages / per)
    return dict(body="wgmma", bm=bm, bn=bn, bk=BF16_BK, wg=wg, tiles=tiles,
                stages=stages, splits=splits, per=per,
                code=plan_code(per, splits, bm, _DTYPE_CODES[torch.bfloat16]))


@functools.lru_cache(maxsize=None)
def _library():
    path, _ = build_library("int8_matmul", SOURCES)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int8_matmul_launch.argtypes = [p] * 4 + [i] * 5 + [p]
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
    """(x contiguous, K, N, device index) of inputs the kernel takes;
    raises ``ValueError`` on any other."""
    if x.dtype not in _DTYPE_CODES:
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
    if not x.is_contiguous():
        x = x.contiguous()
    if (x.data_ptr() | q.data_ptr() | s.data_ptr()) % 16:
        raise ValueError("every operand must start 16-byte aligned")
    return x, k, n, dev


def int8_matmul_cuda(x, q, s):
    """Launch kernel K10: ``x [..., K]`` (float32 or bfloat16, CUDA),
    ``q`` int8 ``[K, N]`` contiguous, ``s`` float32 with ``N`` elements;
    ``N % 16 == 0`` and ``K % 8 == 0``. Returns ``[..., N]`` in x's
    dtype. Raises ``ValueError`` on inputs the kernel does not take and
    ``RuntimeError`` when the launch fails."""
    x, k, n, dev = _check(x, q, s)
    out = x.new_empty((*x.shape[:-1], n))
    m = x.numel() // k
    if m == 0:
        return out
    rc = _library().int8_matmul_launch(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), m, n, k,
        int8_matmul_plan(m, n, k, x.dtype, _sms(dev))["code"], dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    count_launch(int8_matmul_cuda)
    return out


int8_matmul_cuda.launches = 0


def int8_matmul(x, q, s):
    """``(x @ q) * s``: kernel K10 on a CUDA tensor, the plain version on
    a CPU tensor."""
    return (int8_matmul_cuda if x.is_cuda else int8_matmul_plain)(x, q, s)
