"""Flash attention: the Hopper kernels for K1/K3 (forward) and K2/K4
(backward), their plain versions, and the autograd Function around them.

Replaces the Pallas TPU kernels of
``paddle_tpu/ops/pallas/flash_attention.py``: the forward ``_fwd_kernel``
(K1) and ``_fwd_kernel_tri`` (K3), and the backward
``_dq_kernel``/``_dkv_kernel`` (K2) and their triangle forms (K4).
The triangle fold only works around Mosaic's in-order grid, so on Hopper
each pair is one kernel: one forward, one dq and one dkv kernel, CUDA C++
for ``sm_90a`` in ``paddle_tpu_torch/csrc/flash_attention.cu``, built with
``nvcc`` on first use and called through ``ctypes``. The source's header
note says how they work.

What bounds them on an H100: at Llama training shapes (s=4096, d=128) the
forward does about 10^3 operations per byte it must move, so it is bound
by operations (tensor-core rate in bf16). The design never writes the
``s x s`` scores to device memory: for bf16 the 64 x 64 score tiles, P and
dS stay in registers between ``mma.sync`` tensor-core products, with the
streamed K/V (or Q/dO) tiles double-buffered in shared memory by
``cp.async``; causal tiles stop at the diagonal and the longest launch
first.

Layout as in the JAX package: q ``[b, sq, h, d]``, k/v ``[b, sk, kv, d]``
(``h`` a multiple of ``kv``: grouped-query attention without expanding
K/V), ``lse`` f32 ``[b, h, sq]``. Causal attention needs ``sq == sk``:
within the JAX package the kernels align a causal mask top-left and the
plain composition bottom-right when the lengths differ, and the port does
not choose between them yet, so both devices raise.

:func:`flash_attention_fwd_reference` and :func:`flash_attention_bwd_reference`
are the plain PyTorch versions (the backward is the FA2 algebra from
``lse``, not autograd of the forward). A CPU tensor runs them; a CUDA
tensor launches the kernels or raises, and never falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import build_library

HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_SOURCES = ["flash_attention.cu"]


def check_causal_lengths(sq, sk, causal):
    """Raise on causal attention with ``sq != sk`` (see the module note)."""
    if causal and sq != sk:
        raise ValueError(
            f"causal attention with sq={sq} != sk={sk}: the JAX package "
            f"aligns such a mask top-left in its kernels and bottom-right "
            f"in its plain composition; the port takes neither until that "
            f"is settled")


def _check(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [b, sq, h, d] and k, v [b, sk, kv, d]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head_dim")
    kv = k.shape[2]
    if kv < 1 or h % kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {kv}")
    check_causal_lengths(sq, k.shape[1], causal)


def _scores(q, k, causal, scale):
    """f32 ``[b, h, sq, sk]`` scores of q against K/V heads expanded to
    h, with -inf above the causal diagonal."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2:]
        keep = torch.ones(sq, sk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def _expand(x, g):
    return x.repeat_interleave(g, dim=2) if g > 1 else x


def flash_attention_fwd_reference(q, k, v, causal, scale):
    """Plain version of the forward: masked softmax in f32. Returns
    (out in q's dtype ``[b, sq, h, d]``, lse f32 ``[b, h, sq]``)."""
    _check(q, k, v, causal)
    g = q.shape[2] // k.shape[2]
    s = _scores(q, _expand(k, g), causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, _expand(v, g).float())
    return out.to(q.dtype), lse


def flash_attention_bwd_reference(q, k, v, out, lse, dout, causal, scale):
    """Plain version of the backward, the FA2 algebra from the saved lse:
    ``P = exp(S - lse)``, ``dV = P^T dO``, ``dP = dO V^T``,
    ``dS = P (dP - delta)`` with ``delta = rowsum(dO * O)``,
    ``dQ = dS K scale``, ``dK = dS^T Q scale``; the K/V gradients of a
    GQA group are summed over its query heads. f32 math, results in the
    input dtypes."""
    _check(q, k, v, causal)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    ke, ve = _expand(k, g).float(), _expand(v, g).float()
    p = torch.exp(_scores(q, ke, causal, scale) - lse[..., None])
    do = dout.float()
    delta = (do * out.float()).sum(-1).transpose(1, 2)          # [b, h, sq]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, ve) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, ke) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dk = dk.reshape(b, sk, kv, g, d).sum(3)
    dv = dv.reshape(b, sk, kv, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    path, _ = build_library("flash_attention", _SOURCES)
    lib = ctypes.CDLL(str(path))
    # strides, then B, H, KV, sq, sk, d, dtype, causal, then scale
    tail = ([ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 8
            + [ctypes.c_float])
    lib.flash_fwd_launch.argtypes = [ctypes.c_void_p] * 5 + tail + [
        ctypes.c_void_p]
    lib.flash_fwd_launch.restype = ctypes.c_int
    lib.flash_bwd_launch.argtypes = [ctypes.c_void_p] * 9 + tail + [
        ctypes.c_int, ctypes.c_void_p]
    lib.flash_bwd_launch.restype = ctypes.c_int
    return lib


def build() -> str:
    """Build (or reuse) the kernel library now; returns the compiler
    log ("" when an earlier build was reused)."""
    _, log = build_library("flash_attention", _SOURCES)
    _library()
    return log


def _check_cuda(tensors):
    q = tensors[0]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype}: the kernels take float32 and "
                         f"bfloat16")
    if any(t.dtype != q.dtype for t in tensors):
        raise ValueError("q, k, v (and out, dout) must share one dtype")
    devs = {t.device for t in tensors}
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"all tensors must lie on one CUDA device, got "
                         f"{sorted(map(str, devs))}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[3]}: the kernels take "
                         f"{HEAD_DIMS}")


def _rows_aligned(t):
    """``t`` itself when its rows (last dim) are contiguous and every row
    starts on 16 bytes, as the kernels' vector loads need; else a
    contiguous copy."""
    vec = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    vals += [0] * (12 - len(vals))
    return (ctypes.c_longlong * 12)(*vals)


def flash_attention_fwd_cuda(q, k, v, causal, scale):
    """Launch the forward kernel (K1/K3). Same contract as
    :func:`flash_attention_fwd_reference`. Raises ``ValueError`` on
    inputs the kernel does not take and ``RuntimeError`` when the launch
    fails."""
    _check(q, k, v, causal)
    _check_cuda((q, k, v))
    q, k, v = (_rows_aligned(t) for t in (q, k, v))
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if b * sq * h == 0 or sk == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    out = torch.empty((b, sq, h, d), device=q.device, dtype=q.dtype)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    strides = _strides(q, k, v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _library().flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), strides, b, h, kv, sq, sk, d,
            _DTYPE_CODES[q.dtype], int(causal), float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention forward launch failed: CUDA "
                           f"error {rc}")
    flash_attention_fwd_cuda.launches += 1
    return out, lse


flash_attention_fwd_cuda.launches = 0


def _launch_bwd(which, q, k, v, dout, lse, delta, causal, scale, outs):
    _check(q, k, v, causal)
    _check_cuda((q, k, v, dout))
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    for name, t in (("lse", lse), ("delta", delta)):
        if (tuple(t.shape) != (b, h, sq) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous f32 [b, h, sq] = "
                             f"{(b, h, sq)} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    q, k, v, dout = (_rows_aligned(t) for t in (q, k, v, dout))
    dq, dk, dv = outs
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _library().flash_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq, dk, dv,
            _strides(q, k, v, dout), b, h, kv, sq, sk, d,
            _DTYPE_CODES[q.dtype], int(causal), float(scale), which, stream)
    if rc != 0:
        raise RuntimeError(f"flash attention {('dq', 'dkv')[which]} launch "
                           f"failed: CUDA error {rc}")


def flash_attention_dq_cuda(q, k, v, dout, lse, delta, causal, scale):
    """Launch the dq kernel (K2/K4): ``dq [b, sq, h, d]`` from the saved
    ``lse`` and ``delta = rowsum(dout * out)``, both f32 ``[b, h, sq]``
    and contiguous."""
    dq = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    _launch_bwd(0, q, k, v, dout, lse, delta, causal, scale,
                (dq.data_ptr(), None, None))
    flash_attention_dq_cuda.launches += 1
    return dq


flash_attention_dq_cuda.launches = 0


def flash_attention_dkv_cuda(q, k, v, dout, lse, delta, causal, scale):
    """Launch the dkv kernel (K2/K4): ``dk, dv [b, sk, kv, d]``, each
    summed over the query heads of its GQA group."""
    dk = torch.empty(k.shape, device=k.device, dtype=k.dtype)
    dv = torch.empty(v.shape, device=v.device, dtype=v.dtype)
    _launch_bwd(1, q, k, v, dout, lse, delta, causal, scale,
                (None, dk.data_ptr(), dv.data_ptr()))
    flash_attention_dkv_cuda.launches += 1
    return dk, dv


flash_attention_dkv_cuda.launches = 0


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal, scale):
    """The backward on the card: same contract as
    :func:`flash_attention_bwd_reference`. ``delta = rowsum(dout * out)``
    is computed here in plain torch, as the JAX package computes it
    outside its kernels; then the dq and dkv kernels run."""
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    lse = lse.contiguous()
    dq = flash_attention_dq_cuda(q, k, v, dout, lse, delta, causal, scale)
    dk, dv = flash_attention_dkv_cuda(q, k, v, dout, lse, delta, causal,
                                      scale)
    return dq, dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its FA2 backward. Saves ``q, k, v, out, lse``
    for the backward, as the JAX package's ``_flash_fwd`` does. A CUDA
    tensor runs the kernels, a CPU tensor the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        fwd = (flash_attention_fwd_cuda if q.is_cuda
               else flash_attention_fwd_reference)
        out, lse = fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd_cuda if q.is_cuda
               else flash_attention_bwd_reference)
        dq, dk, dv = bwd(q, k, v, out, lse, dout, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None

