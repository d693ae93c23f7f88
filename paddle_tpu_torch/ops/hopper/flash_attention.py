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
by operations (tensor-core rate in bf16), and the backward's two kernels
more so. No kernel writes the ``s x s`` scores to device memory. The
bf16 kernels are built for Hopper: one thread streams tiles by TMA into
rings of shared-memory stages; two consumer warpgroups run every product
with ``wgmma``, P and dS as A from registers; only the tiles that cross
the causal diagonal (and, in the forward and dq, a ragged last key tile)
are masked. The forward's CTA owns a 128-row q tile and streams K/V, its
warpgroups taking turns on the tensor cores so that one's softmax (in the
log2 domain) runs beside the other's products; the dq kernel's CTA owns
a 128-row q tile and streams 64-key tiles; the dkv kernel's owns a
128-key tile and streams 64-query tiles of Q, dO, lse and delta for each
query head of the GQA group. :func:`fwd_tile_plan`,
:func:`fwd_cta_order`, :func:`fwd_schedule_model`, :func:`bwd_tile_plan`
and :func:`bwd_schedule_model` are plain models of those schedules. The
f32 kernels keep 64-row tiles of 4 warps on the CUDA cores; causal tiles
stop at the diagonal and the longest launch first.

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

The kernels take f32, bf16 and fp16 and tile head_dim 64, 128 and 256.
Any other head_dim up to 256 runs zero-padded to the narrowest of them
that holds it (:func:`padded_head_dim`: 64 below 64, 128 up to 128, 256
above): DiT-XL/2's 72 (hidden 1152 over 16 heads) and the
Stable-Diffusion UNet's 8 (its ``attention_head_dim`` is the per-head
width) among them. bf16 and fp16 at 64 and 128 take the TMA/``wgmma``
kernels (one template over the 16-bit type); f32, and every type at 256,
the CUDA-core kernels: at 256 a forward with the f32 one's tiles, and a
dq and a dkv (a dK and a dV launch) that keep one streamed tile in
shared memory, P and dS rounded to the 16-bit type before their
products as the tensor-core kernels round them.
:func:`flash_attention_fwd_padded` and :func:`flash_attention_bwd_padded`
zero-pad q, k, v (and out, dout) to that width, run the kernels with the
caller's scale (``1/sqrt(d)``, not that of the padded width) and slice
out, dq, dk and dv back to ``d`` columns. Zero columns add nothing to
``QK^T``, and their outputs and gradients are zero, so the padded result
is the unpadded one. A head_dim above 256 raises on the card, as the
JAX package's Pallas path refuses there.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import build_library, count_launch

HEAD_DIMS = (64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
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
    (out in q's dtype ``[b, sq, h, d]``, lse f32 ``[b, h, sq]``). P stays
    f32 here; the kernels round it to a 16-bit q's dtype (bf16 or fp16)
    before ``P V`` (:func:`fwd_schedule_model` models that), so the two
    agree within that rounding."""
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


def padded_head_dim(d):
    """The kernels' width that head_dim ``d`` runs at: ``d`` itself for
    64, 128 and 256, else the narrowest of them above ``d``, zero-padded
    (see the module note). Above 256 it raises, as the JAX package's
    Pallas path refuses there."""
    if d > HEAD_DIMS[-1]:
        raise ValueError(f"head_dim {d}: the kernels take up to "
                         f"{HEAD_DIMS[-1]}")
    return next((w for w in HEAD_DIMS if 0 < d <= w), None)


def pad_head_dim(t, width):
    """``t`` (``[..., d]``) with zero columns appended up to ``width``."""
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def flash_attention_fwd_padded(q, k, v, causal, scale,
                               fwd=flash_attention_fwd_reference):
    """The forward at a head_dim the kernels do not tile: ``fwd`` (the
    kernel's wrapper on the card) on q, k, v zero-padded to
    :func:`padded_head_dim`, with the caller's ``scale``; out sliced back
    to ``d`` columns, lse as it comes."""
    d = q.shape[-1]
    width = padded_head_dim(d)
    out, lse = fwd(*(pad_head_dim(t, width) for t in (q, k, v)), causal,
                   scale)
    return out[..., :d], lse


def flash_attention_bwd_padded(q, k, v, out, lse, dout, causal, scale,
                               bwd=flash_attention_bwd_reference):
    """The backward at a head_dim the kernels do not tile: ``bwd`` on q,
    k, v, out and dout zero-padded to :func:`padded_head_dim` (delta =
    rowsum(dout * out) is unchanged by zero columns), with the caller's
    ``scale``; dq, dk and dv sliced back to ``d`` columns."""
    d = q.shape[-1]
    width = padded_head_dim(d)
    qp, kp, vp, op, dop = (pad_head_dim(t, width)
                           for t in (q, k, v, out, dout))
    grads = bwd(qp, kp, vp, op, lse, dop, causal, scale)
    return tuple(g[..., :d] for g in grads)


# The bf16 forward's tiles (csrc/flash_attention.cu: kFwdBM, kFwdBN) and
# the K/V bytes a group of CTAs keeps in L2
FWD_BLOCK_M = FWD_BLOCK_N = 128
FWD_GROUP_BYTES = 16 << 20


def fwd_tile_plan(q0, sq, sk, causal):
    """The key tiles the bf16 forward's CTA for the q tile at row ``q0``
    visits, in its order: ``[(k0, masked), ...]`` from the last tile down.
    A causal tile stops at the diagonal; only the tiles that cross the
    diagonal, or the ragged end of the keys, take the mask (they come
    first)."""
    kend = min(sk, q0 + FWD_BLOCK_M) if causal else sk
    ntk = -(-kend // FWD_BLOCK_N)
    first_masked = (q0 // FWD_BLOCK_N if causal
                    else ntk - 1 if sk % FWD_BLOCK_N else ntk)
    return [(kt * FWD_BLOCK_N, kt >= first_masked)
            for kt in range(ntk - 1, -1, -1)]


def fwd_group(b, h, kv, sk, d):
    """(batch, head) pairs per group of the bf16 forward's CTAs, which
    the wrapper passes to the kernel: as many as keep their K/V within
    FWD_GROUP_BYTES of L2 (a query head's share of a GQA group's K/V
    counted once)."""
    kv_per_head = max(1, 4 * sk * d // (h // kv))
    return max(1, min(b * h, FWD_GROUP_BYTES // kv_per_head))


def fwd_cta_order(b, h, kv, sq, sk, d):
    """The bf16 forward's CTAs in launch order, as the kernel maps its
    block index: ``[(bh, q0), ...]`` with ``bh = batch * h + head``.
    Groups of :func:`fwd_group` (batch, head) pairs, the heaviest q tile
    first within a group."""
    ntiles = -(-sq // FWD_BLOCK_M)
    group = fwd_group(b, h, kv, sk, d)
    order = []
    for x in range(ntiles * b * h):
        grp0 = x // (group * ntiles) * group
        gc = min(group, b * h - grp0)
        within = x - grp0 * ntiles
        order.append((grp0 + within % gc,
                      (ntiles - 1 - within // gc) * FWD_BLOCK_M))
    return order


def fwd_schedule_model(q, k, v, causal, scale):
    """Plain model of the bf16 forward's schedule and arithmetic, the
    contract of :func:`flash_attention_fwd_reference`: per q tile, the key
    tiles of :func:`fwd_tile_plan` with rows and keys past ``sq``/``sk``
    zero (as TMA fills them) and the mask on the plan's tiles only; the
    online softmax in the log2 domain (``p = 2^(s scale log2e - m scale
    log2e)``, a row with no key yet subtracts 0), ``l`` summed from the
    f32 ``p``, ``P`` rounded to the input dtype before ``P V``, and
    ``lse = (m scale log2e + log2 l) ln 2``."""
    _check(q, k, v, causal)
    b, sq, h, d = q.shape
    sk, g = k.shape[1], h // k.shape[2]
    scale_log2 = scale * math.log2(math.e)
    pad_q, pad_k = -sq % FWD_BLOCK_M, -sk % FWD_BLOCK_N
    qf = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q)).float()
    kf, vf = (torch.nn.functional.pad(_expand(t, g), (0, 0, 0, 0, 0, pad_k))
              .float() for t in (k, v))
    out = torch.empty(b, sq, h, d, dtype=q.dtype)
    lse = torch.empty(b, h, sq)
    cols = torch.arange(FWD_BLOCK_N)
    for q0 in range(0, sq, FWD_BLOCK_M):
        rows = q0 + torch.arange(FWD_BLOCK_M)
        qt = qf[:, q0:q0 + FWD_BLOCK_M]
        m = torch.full((b, h, FWD_BLOCK_M), -math.inf)
        l = torch.zeros(b, h, FWD_BLOCK_M)
        o = torch.zeros(b, h, FWD_BLOCK_M, d)
        for k0, masked in fwd_tile_plan(q0, sq, sk, causal):
            s = torch.einsum("bqhd,bkhd->bhqk", qt,
                             kf[:, k0:k0 + FWD_BLOCK_N])
            if masked:
                c = (k0 + cols)[None, :]
                drop = (c >= sk) | (causal & (c > rows[:, None]))
                s = s.masked_fill(drop, -math.inf)
            mx = torch.maximum(m, s.amax(-1))
            ms = torch.where(mx == -math.inf, 0.0, mx * scale_log2)
            alpha = torch.exp2(m * scale_log2 - ms)
            p = torch.exp2(s * scale_log2 - ms[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(q.dtype).float(),
                vf[:, k0:k0 + FWD_BLOCK_N])
            m = mx
        n = min(FWD_BLOCK_M, sq - q0)
        out[:, q0:q0 + n] = (o / l[..., None]).transpose(1, 2)[:, :n].to(
            q.dtype)
        lse[..., q0:q0 + n] = ((m * scale_log2 + torch.log2(l))
                               * math.log(2.0))[..., :n]
    return out, lse


# The bf16 backward's tiles (csrc/flash_attention.cu): a dq CTA's q rows
# and the keys of the tiles it streams (kDqBM, kDqBN); a dkv CTA's keys and
# the queries of the tiles it streams (kDkvBN, kDkvBM)
DQ_BLOCK_M, DQ_BLOCK_N = 128, 64
DKV_BLOCK_N, DKV_BLOCK_M = 128, 64


def dkv_group(b, h, kv, sq, d):
    """(batch, KV head) pairs per group of the bf16 dkv kernel's CTAs,
    which the wrapper passes to the kernel: as many as keep their Q and
    dO (all g query heads of the GQA group) within FWD_GROUP_BYTES of
    L2. The dq kernel shares K/V as the forward does and takes
    :func:`fwd_group`."""
    qdo_per_pair = max(1, 4 * sq * d * (h // kv))
    return max(1, min(b * kv, FWD_GROUP_BYTES // qdo_per_pair))


def bwd_tile_plan(kernel, start, sq, sk, causal, g=1):
    """The tiles a bf16 backward CTA visits, in its order, and which of
    them take the mask. ``kernel="dq"``: the CTA of the q tile at row
    ``start``, ``[(k0, masked), ...]`` over its 64-key tiles from the
    last down; a causal tile stops at the diagonal, and the tiles that
    cross it, or the ragged end of the keys, are masked. ``kernel="dkv"``:
    the CTA of the key tile at ``start``, ``[(t, q0, masked), ...]`` over
    the 64-query tiles of each of the group's ``g`` query heads in turn;
    a causal key tile starts at its diagonal and only the q tiles that
    cross it are masked (padding needs no mask there: a query past
    ``sq`` takes lse = +inf, and no key row past ``sk`` is stored)."""
    if kernel == "dq":
        kend = min(sk, start + DQ_BLOCK_M) if causal else sk
        ntk = -(-kend // DQ_BLOCK_N)
        first_masked = (start // DQ_BLOCK_N if causal
                        else ntk - 1 if sk % DQ_BLOCK_N else ntk)
        return [(kt * DQ_BLOCK_N, kt >= first_masked)
                for kt in range(ntk - 1, -1, -1)]
    if kernel == "dkv":
        qstart = start if causal else 0
        return [(t, q0, causal and q0 < start + DKV_BLOCK_N)
                for t in range(g) for q0 in range(qstart, sq, DKV_BLOCK_M)]
    raise ValueError(f"kernel {kernel!r}: want 'dq' or 'dkv'")


def bwd_schedule_model(q, k, v, out, lse, dout, causal, scale):
    """Plain model of the bf16 backward kernels' schedule and arithmetic,
    the contract of :func:`flash_attention_bwd_reference`: ``delta`` from
    ``dout`` and ``out`` as the wrapper computes it; rows past ``sq`` and
    keys past ``sk`` zero (as TMA fills them), a row past ``sq`` with
    lse = +inf and delta = 0; per CTA the tiles of :func:`bwd_tile_plan`
    with the mask on its masked tiles only; ``P = 2^(S scale log2e - lse
    log2e)``, ``dS = P (dP - delta)``, both f32, each rounded to the input
    dtype before its product; dK and dV of a KV head summed over the
    group's query heads in order, then over their q tiles; the scale
    applied to dq and dk at the end."""
    _check(q, k, v, causal)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g, dt = h // kv, q.dtype
    log2e = math.log2(math.e)
    scale_log2 = scale * log2e
    pad = torch.nn.functional.pad
    pad_q, pad_k = -sq % DQ_BLOCK_M, -sk % DKV_BLOCK_N
    qf, dof = (pad(t, (0, 0, 0, 0, 0, pad_q)).float() for t in (q, dout))
    kf, vf = (pad(t, (0, 0, 0, 0, 0, pad_k)).float() for t in (k, v))
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    lse2 = pad(lse.float() * log2e, (0, pad_q), value=math.inf)
    dl = pad(delta, (0, pad_q))

    def rnd(x):
        return x.to(dt).float()

    ke, ve = _expand(kf, g), _expand(vf, g)
    dq = torch.empty(b, sq, h, d, dtype=dt)
    cols = torch.arange(DQ_BLOCK_N)
    for q0 in range(0, sq, DQ_BLOCK_M):
        rows, sl = q0 + torch.arange(DQ_BLOCK_M), slice(q0, q0 + DQ_BLOCK_M)
        acc = torch.zeros(b, h, DQ_BLOCK_M, d)
        for k0, masked in bwd_tile_plan("dq", q0, sq, sk, causal):
            kt, vt = ke[:, k0:k0 + DQ_BLOCK_N], ve[:, k0:k0 + DQ_BLOCK_N]
            s = torch.einsum("bqhd,bkhd->bhqk", qf[:, sl], kt)
            p = torch.exp2(s * scale_log2 - lse2[:, :, sl, None])
            if masked:
                c = (k0 + cols)[None, :]
                p = p.masked_fill((c >= sk) | (causal & (c > rows[:, None])),
                                  0.0)
            dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, sl], vt)
            acc += torch.einsum("bhqk,bkhd->bhqd",
                                rnd(p * (dp - dl[:, :, sl, None])), kt)
        n = min(DQ_BLOCK_M, sq - q0)
        dq[:, q0:q0 + n] = (acc * scale).transpose(1, 2)[:, :n].to(dt)

    # query head kh * g + t of KV head kh
    qg, dog = (t.reshape(b, -1, kv, g, d) for t in (qf, dof))
    lg, dlg = (t.reshape(b, kv, g, -1) for t in (lse2, dl))
    dk = torch.empty(b, sk, kv, d, dtype=dt)
    dv = torch.empty(b, sk, kv, d, dtype=dt)
    for k0 in range(0, sk, DKV_BLOCK_N):
        keys = (k0 + torch.arange(DKV_BLOCK_N))[:, None]
        kt, vt = (t[:, k0:k0 + DKV_BLOCK_N] for t in (kf, vf))
        adk = torch.zeros(b, kv, DKV_BLOCK_N, d)
        adv = torch.zeros(b, kv, DKV_BLOCK_N, d)
        for t, q0, masked in bwd_tile_plan("dkv", k0, sq, sk, causal, g):
            sl = slice(q0, q0 + DKV_BLOCK_M)
            qt, dot = qg[:, sl, :, t], dog[:, sl, :, t]
            st = torch.einsum("bkhd,bqhd->bhkq", kt, qt)
            p = torch.exp2(st * scale_log2 - lg[:, :, t, None, sl])
            if masked:
                p = p.masked_fill(keys > q0 + torch.arange(DKV_BLOCK_M), 0.0)
            adv += torch.einsum("bhkq,bqhd->bhkd", rnd(p), dot)
            dpt = torch.einsum("bkhd,bqhd->bhkq", vt, dot)
            adk += torch.einsum("bhkq,bqhd->bhkd",
                                rnd(p * (dpt - dlg[:, :, t, None, sl])), qt)
        n = min(DKV_BLOCK_N, sk - k0)
        dk[:, k0:k0 + n] = (adk * scale).transpose(1, 2)[:, :n].to(dt)
        dv[:, k0:k0 + n] = adv.transpose(1, 2)[:, :n].to(dt)
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _library():
    path, _ = build_library("flash_attention", _SOURCES)
    lib = ctypes.CDLL(str(path))
    # strides, then B, H, KV, sq, sk, d, dtype, causal, then scale
    tail = ([ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 8
            + [ctypes.c_float])
    # the forward then takes the CTA group (fwd_group), then the stream;
    # the backward which kernel, its CTA group, then the stream
    lib.flash_fwd_launch.argtypes = [ctypes.c_void_p] * 5 + tail + [
        ctypes.c_int, ctypes.c_void_p]
    lib.flash_fwd_launch.restype = ctypes.c_int
    lib.flash_bwd_launch.argtypes = [ctypes.c_void_p] * 9 + tail + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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
        raise ValueError(f"dtype {q.dtype}: the kernels take float32, "
                         f"bfloat16 and float16")
    if any(t.dtype != q.dtype for t in tensors):
        raise ValueError("q, k, v (and out, dout) must share one dtype")
    devs = {t.device for t in tensors}
    if len(devs) != 1 or q.device.type != "cuda":
        raise ValueError(f"all tensors must lie on one CUDA device, got "
                         f"{sorted(map(str, devs))}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[3]}: the kernels take "
                         f"{HEAD_DIMS}, and any other head_dim up to "
                         f"{HEAD_DIMS[-1]} zero-padded")


def _runs_padded(d):
    return d not in HEAD_DIMS and 0 < d <= HEAD_DIMS[-1]


def _rows_aligned(t):
    """``t`` itself when its rows (last dim) are contiguous and every row
    starts on 16 bytes, as the kernels' vector loads need; else a
    contiguous copy. The test is also what the bf16 forward's TMA maps
    need (a 16-byte aligned base, strides in multiples of 16 bytes), so
    the kernel never meets a tensor its maps cannot take."""
    vec = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _form(q):
    """A launch's form, the key of ``<wrapper>.launches_by_form``: the
    input type and the head width the kernel ran at, ``torch.bfloat16/d64``."""
    return f"{q.dtype}/d{q.shape[3]}"


def _strides(*tensors):
    vals = [s for t in tensors for s in t.stride()[:3]]
    vals += [0] * (12 - len(vals))
    return (ctypes.c_longlong * 12)(*vals)


def flash_attention_fwd_cuda(q, k, v, causal, scale):
    """Launch the forward kernel (K1/K3): for bf16 and fp16 at head_dim
    64 and 128 the TMA/``wgmma`` kernel, for f32 and at head_dim 256 the
    CUDA-core one. Same contract as :func:`flash_attention_fwd_reference`.
    Raises ``ValueError`` on inputs the kernel does not take and
    ``RuntimeError`` when the launch fails. Any other head_dim up to 256
    runs zero-padded (:func:`flash_attention_fwd_padded`)."""
    if _runs_padded(q.shape[-1]):
        return flash_attention_fwd_padded(q, k, v, causal, scale,
                                          fwd=flash_attention_fwd_cuda)
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
            _DTYPE_CODES[q.dtype], int(causal), float(scale),
            fwd_group(b, h, kv, sk, d), stream)
    if rc != 0:
        raise RuntimeError(f"flash attention forward launch failed: CUDA "
                           f"error {rc}")
    count_launch(flash_attention_fwd_cuda, _form(q))
    return out, lse


flash_attention_fwd_cuda.launches = 0
flash_attention_fwd_cuda.launches_by_form = {}


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
    group = fwd_group(b, h, kv, sk, d) if which == 0 else dkv_group(
        b, h, kv, sq, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _library().flash_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq, dk, dv,
            _strides(q, k, v, dout), b, h, kv, sq, sk, d,
            _DTYPE_CODES[q.dtype], int(causal), float(scale), which, group,
            stream)
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
    count_launch(flash_attention_dq_cuda, _form(q))
    return dq


flash_attention_dq_cuda.launches = 0
flash_attention_dq_cuda.launches_by_form = {}


def flash_attention_dkv_cuda(q, k, v, dout, lse, delta, causal, scale):
    """Launch the dkv kernel (K2/K4): ``dk, dv [b, sk, kv, d]``, each
    summed over the query heads of its GQA group."""
    dk = torch.empty(k.shape, device=k.device, dtype=k.dtype)
    dv = torch.empty(v.shape, device=v.device, dtype=v.dtype)
    _launch_bwd(1, q, k, v, dout, lse, delta, causal, scale,
                (None, dk.data_ptr(), dv.data_ptr()))
    # at head_dim 256 one call launches a dK and a dV kernel
    count_launch(flash_attention_dkv_cuda, _form(q),
                 kernels=2 if q.shape[3] == 256 else 1)
    return dk, dv


flash_attention_dkv_cuda.launches = 0
flash_attention_dkv_cuda.launches_by_form = {}


def flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal, scale):
    """The backward on the card: same contract as
    :func:`flash_attention_bwd_reference`. ``delta = rowsum(dout * out)``
    is computed here in plain torch, as the JAX package computes it
    outside its kernels; then the dq and dkv kernels run (at head_dim
    256 the dkv wrapper's one call launches a dK and a dV kernel). Any
    other head_dim up to 256 runs zero-padded
    (:func:`flash_attention_bwd_padded`)."""
    if _runs_padded(q.shape[-1]):
        return flash_attention_bwd_padded(q, k, v, out, lse, dout, causal,
                                          scale, bwd=flash_attention_bwd_cuda)
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

