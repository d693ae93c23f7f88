"""Ragged paged attention: the Hopper kernel K5 and its plain version.

Replaces the Pallas TPU kernel ``paddle_tpu/ops/pallas/paged_attention.py``
(``paged_attend_pallas`` -> ``_kernel``). The kernel is CUDA C++ for
``sm_90a`` (``paddle_tpu_torch/csrc/paged_attention.cu``), compiled with
``nvcc`` into a shared library with a plain C interface on first use and
called through ``ctypes``. The source's header note says how it works.

What bounds it on an H100: a decode step reads each row's resident K/V
pages once and does a few flops per byte, so it is bound by HBM bytes.
The design reads the pages in place through the block tables (no
gathered copy of the context), stops at each q tile's causal horizon,
and shares every K/V load among the ``g`` query heads of a GQA group.
It does not yet split a long row across CTAs; at 8 decode slots the
grid is ``8 x kv_heads`` CTAs.

:func:`paged_attend_reference` is the plain PyTorch version: it gathers
each row's whole table and runs the masked softmax in f32. The tests
use it on the CPU, and ``chip_smoke.py`` holds the kernel against it on
the card. :func:`paged_attend_cuda` launches the kernel and raises on a
shape it does not take; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import build_library

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
MAX_GROUP = 64          # query heads per KV head a CTA can hold
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def paged_attend_reference(q, kbuf, vbuf, block_tables, positions, *,
                           kv_heads, head_dim):
    """q ``[B, s, h, d]`` against the block-table pages of
    kbuf/vbuf ``[num_blocks, bs, kv, d]``; column t is visible to chunk
    row r iff ``t <= positions[b] + r``. Returns f32 ``[B, s, kv, g, d]``."""
    b, s, h, d = q.shape
    bs = kbuf.shape[1]
    t_total = block_tables.shape[1] * bs
    tables = block_tables.long()
    kg = kbuf[tables].reshape(b, t_total, kv_heads, head_dim)
    vg = vbuf[tables].reshape(b, t_total, kv_heads, head_dim)
    g = h // kv_heads
    qg = q.reshape(b, s, kv_heads, g, d)
    scores = torch.einsum("bqkgd,btkd->bqkgt", qg.float(),
                          kg.float()) / float(head_dim) ** 0.5
    idx = (positions.long()[:, None]
           + torch.arange(s, device=q.device)[None, :])          # [B, s]
    mask = (torch.arange(t_total, device=q.device)[None, None, :]
            <= idx[:, :, None])
    scores = scores.masked_fill(~mask[:, :, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bqkgt,btkd->bqkgd", p, vg.float())


@functools.lru_cache(maxsize=None)
def _library():
    path, _ = build_library("paged_attention", ["paged_attention.cu"])
    lib = ctypes.CDLL(str(path))
    fn = lib.paged_attend_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def build() -> str:
    """Build (or reuse) the kernel library now; returns the compiler
    log ("" when an earlier build was reused)."""
    _, log = build_library("paged_attention", ["paged_attention.cu"])
    _library()
    return log


def _check(q, kbuf, vbuf, block_tables, positions, kv_heads, head_dim):
    if q.dim() != 4 or kbuf.dim() != 4:
        raise ValueError(f"want q [B, s, h, d] and a pool [num_blocks, bs, "
                         f"kv, d]; got {tuple(q.shape)} and "
                         f"{tuple(kbuf.shape)}")
    b, s, h, d = q.shape
    if d != head_dim or head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} (q has {d}): the kernel "
                         f"takes {HEAD_DIMS}")
    if kbuf.shape != vbuf.shape or tuple(kbuf.shape[2:]) != (kv_heads, d):
        raise ValueError(f"pool shapes {tuple(kbuf.shape)} / "
                         f"{tuple(vbuf.shape)} do not match kv_heads "
                         f"{kv_heads}, head_dim {d}")
    if kv_heads < 1 or h % kv_heads or h // kv_heads > MAX_GROUP:
        raise ValueError(f"{h} query heads over {kv_heads} KV heads: want "
                         f"a whole group of at most {MAX_GROUP}")
    if q.dtype not in _DTYPE_CODES or kbuf.dtype != q.dtype \
            or vbuf.dtype != q.dtype:
        raise ValueError(f"q/pool dtypes {q.dtype}/{kbuf.dtype}/"
                         f"{vbuf.dtype}: want one of float32, bfloat16, "
                         f"float16 for all three")
    if (block_tables.dtype != torch.int32 or positions.dtype != torch.int32
            or block_tables.dim() != 2 or block_tables.shape[0] != b
            or tuple(positions.shape) != (b,)):
        raise ValueError("want int32 block_tables [B, max_blocks] and "
                         "int32 positions [B]")
    devs = {t.device for t in (q, kbuf, vbuf, block_tables, positions)}
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"all tensors must lie on one CUDA device, got "
                         f"{sorted(map(str, devs))}")
    if not (kbuf.is_contiguous() and vbuf.is_contiguous()):
        raise ValueError("the KV pool buffers must be contiguous")


def paged_attend_cuda(q, kbuf, vbuf, block_tables, positions, *,
                      kv_heads, head_dim):
    """Launch kernel K5: same contract as :func:`paged_attend_reference`.
    Raises ``ValueError`` on inputs the kernel does not take and
    ``RuntimeError`` when the launch fails."""
    _check(q, kbuf, vbuf, block_tables, positions, kv_heads, head_dim)
    b, s, h, d = q.shape
    q = q.contiguous()
    block_tables = block_tables.contiguous()
    positions = positions.contiguous()
    g = h // kv_heads
    out = torch.empty((b, s, kv_heads, g, d), device=q.device,
                      dtype=torch.float32)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.paged_attend_launch(
            q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(),
            block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            b, s, h, kv_heads, d, kbuf.shape[1], block_tables.shape[1],
            _DTYPE_CODES[q.dtype], 1.0 / float(head_dim) ** 0.5, stream)
    if rc != 0:
        raise RuntimeError(f"paged_attend kernel launch failed: CUDA error "
                           f"{rc}")
    paged_attend_cuda.launches += 1
    return out


paged_attend_cuda.launches = 0
