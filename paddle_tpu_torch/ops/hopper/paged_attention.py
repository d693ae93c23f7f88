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
It splits each row's columns into spans (flash decoding): a persistent
grid writes one partial softmax per span, and a second kernel merges a
row's partials by their log-sum-exp in a fixed order.
:func:`_tensor_cores` picks the body from the dtype and the shape alone
(CUDA cores for f32 and MHA decode, tensor cores for bf16/f16 with 8 or
more query vectors per tile); the kernel picks the span among
``SPAN_CHOICES`` from the positions on the card, and the wrapper reads
nothing back. ``_launch`` can fix the body and the span, which
``chip_smoke.py --k5`` and the card's tests use to measure and check
each choice.

:func:`paged_attend_reference` is the plain PyTorch version: it gathers
each row's whole table and runs the masked softmax in f32. The tests
use it on the CPU, and ``chip_smoke.py`` holds the kernel against it on
the card. :func:`paged_attend_split_reference` computes the same
function the kernel's way, per span and merged, for the CPU tests.
:func:`paged_attend_cuda` launches the kernel and raises on a shape it
does not take; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import build_library, count_launch

NEG_INF = -1e30
HEAD_DIMS = (64, 128)
MAX_GROUP = 64          # query heads per KV head a CTA can hold
TC_MIN_QUERIES = 8      # s * g from which bf16/f16 take the tensor cores
SPAN_CHOICES = (128, 256, 512)  # the spans the kernel chooses among
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


def paged_attend_split_reference(q, kbuf, vbuf, block_tables, positions, *,
                                 kv_heads, head_dim, split_cols):
    """The kernel's algorithm in plain PyTorch, f32: the table's columns
    in spans of ``split_cols``; per span a partial softmax (o normalised,
    log-sum-exp), where a span with no visible column for a row gives
    that row lse ``NEG_INF`` and o 0; the partials merged in span order,
    ``o = sum exp(lse_i - max) o_i / sum exp(lse_i - max)``. Same
    contract as :func:`paged_attend_reference`; for the tests."""
    b, s, h, d = q.shape
    bs = kbuf.shape[1]
    t_total = block_tables.shape[1] * bs
    tables = block_tables.long()
    kg = kbuf[tables].reshape(b, t_total, kv_heads, head_dim).float()
    vg = vbuf[tables].reshape(b, t_total, kv_heads, head_dim).float()
    g = h // kv_heads
    qg = q.reshape(b, s, kv_heads, g, d).float()
    scores = torch.einsum("bqkgd,btkd->bqkgt", qg, kg) / float(head_dim) ** 0.5
    idx = (positions.long()[:, None]
           + torch.arange(s, device=q.device)[None, :])          # [B, s]
    mask = (torch.arange(t_total, device=q.device)[None, None, :]
            <= idx[:, :, None])[:, :, None, None, :]
    scores = scores.masked_fill(~mask, float("-inf"))
    parts = []
    for c0 in range(0, t_total, split_cols):
        sc = scores[..., c0:c0 + split_cols]
        m = sc.amax(-1, keepdim=True)
        m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp(sc - m)                  # 0 at every masked column
        l = p.sum(-1, keepdim=True)
        o = torch.einsum("bqkgt,btkd->bqkgd", p,
                         vg[:, c0:c0 + split_cols]) / l.clamp_min(1e-30)
        parts.append((torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                                  torch.full_like(l, NEG_INF)), o))
    top = torch.stack([lse for lse, _ in parts]).amax(0)
    acc = torch.zeros_like(parts[0][1])
    wsum = torch.zeros_like(top)
    for lse, o in parts:
        w = torch.exp(lse - top)
        acc = acc + w * o
        wsum = wsum + w
    return acc / wsum


def _tensor_cores(dtype, s, g):
    """The body of a call, fixed by the dtype and the shape: f32 stays on
    the CUDA cores (the f32 parity runs and the tests); bf16/f16 take the
    tensor cores once a q tile holds ``TC_MIN_QUERIES`` query vectors
    (GQA decode, prefill)."""
    return dtype != torch.float32 and s * g >= TC_MIN_QUERIES


@functools.lru_cache(maxsize=None)
def _library():
    path, _ = build_library("paged_attention", ["paged_attention.cu"])
    lib = ctypes.CDLL(str(path))
    fn = lib.paged_attend_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
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
    tc = _tensor_cores(q.dtype, q.shape[1], q.shape[2] // kv_heads)
    return _launch(q, kbuf, vbuf, block_tables, positions, kv_heads,
                   head_dim, tensor_cores=tc)


def _launch(q, kbuf, vbuf, block_tables, positions, kv_heads, head_dim, *,
            tensor_cores, split_cols=0):
    """One call of K5 with a given body (checked inputs): the split
    kernel, then the merge kernel when a row can need two spans. The span
    is the kernel's own choice among ``SPAN_CHOICES`` unless
    ``split_cols`` fixes it. Nothing is read back from the card."""
    if q.device.index != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return _launch(q, kbuf, vbuf, block_tables, positions, kv_heads,
                           head_dim, tensor_cores=tensor_cores,
                           split_cols=split_cols)
    b, s, h, d = q.shape
    q = q.contiguous()
    block_tables = block_tables.contiguous()
    positions = positions.contiguous()
    total_q = b * s * h
    spans = -(-block_tables.shape[1] * kbuf.shape[1]
              // (split_cols or SPAN_CHOICES[0]))
    out = torch.empty((b, s, kv_heads, h // kv_heads, d), device=q.device,
                      dtype=torch.float32)
    # partials [spans, total_q, d], their lse, and the chosen span (an int)
    scratch = None
    if spans > 1:
        scratch = torch.empty(spans * total_q * (d + 1) + 1, device=q.device,
                              dtype=torch.float32)
    rc = _library().paged_attend_launch(
        q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(),
        block_tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        b, s, h, kv_heads, d, kbuf.shape[1], block_tables.shape[1],
        _DTYPE_CODES[q.dtype], 1.0 / float(head_dim) ** 0.5, split_cols,
        int(tensor_cores),
        # the current stream's handle, as Triton's launcher reads it: the
        # public torch.cuda.current_stream() costs a few microseconds more
        torch._C._cuda_getCurrentRawStream(q.device.index))
    if rc != 0:
        raise RuntimeError(f"paged_attend kernel launch failed: CUDA error "
                           f"{rc}")
    count_launch(paged_attend_cuda)
    return out


paged_attend_cuda.launches = 0
