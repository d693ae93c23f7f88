#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``paddle_tpu_torch``) on one NVIDIA
H100: the quickest proof that the port builds, runs and is right on the
card. Run from the repository root with ``python3 chip_smoke.py``.

Phases, in order; each one checks its own results and any failure ends
the run with a non-zero exit code and no result line:

1. Device: name, count, ``nvidia-smi`` name and power limit; build the
   kernels from the checkout's sources (one nvcc per CUDA source, all
   started together, while Triton compiles K6).
2. K5 (ragged paged attention, CUDA) against its plain version on the
   same bf16 pool: decode at mixed depths with an idle row, prefill at
   position 0 and 256, a ragged 100-row chunk, and GQA decode.
3. K6 (RMSNorm forward, Triton) against its plain version, bf16; the
   RMSNorm autograd Function's dx/dw on the card against plain autograd.
4. The flash-attention forward, dq and dkv kernels (CUDA) against their
   plain versions: out, lse, dq, dk, dv for causal s=4096 bf16 (the
   training shape), causal s=1024 f32, GQA 32/8, non-causal 256 x 1024,
   a ragged s=200 and d=64.
5. Timings of every kernel with CUDA events: kernel, plain version, one
   PyTorch library call for the same function, and the bound.
6. Serving parity at Llama-2-7B width, 2 layers, f32: engine greedy
   tokens (kernels) equal dense ``generate`` tokens.
7. Serving at full Llama-2-7B (bf16, 32 layers): 8 requests through the
   engine; throughput, TTFT/TPOT, peak memory, exact launch counts; then
   a short torch.profiler window: device time by kernel family and the
   device's idle share.
8. Training parity at Llama-2-7B width, 2 layers, f32, b=1, s=256: the
   loss and every parameter's gradient on the card (kernels) against
   the CPU (plain versions), then a 3-step TrainStep loss trajectory.
9. Training at Llama-2-7B widths, 8 layers, bf16, AdamW with f32
   masters, batch 2 x 4096: 2 warm-up and 5 timed TrainSteps; step
   time, tokens/s, MFU, peak memory, exact launch counts per step, a
   falling loss; then a torch.profiler window as for serving.
10. One ``kernels`` JSON line.
11. The result line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or the JAX package. Without a CUDA device it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and operations/s by
# input type (bf16/f16 tensor cores; f32 outside the tensor cores)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}

# K5: both sides accumulate in f32 over the same bf16 pool; only the
# order of summation differs
K5_ATOL = K5_RTOL = 1e-3
# K6: two bf16 ulps on the output (one rounding each side plus order),
# f32 rstd to 1e-5
K6_ATOL = K6_RTOL = 1.6e-2
K6_RSTD_RTOL = 1e-5

# flash attention: f32 sums in other orders on both sides
FLASH_F32_ATOL = 1e-4
# bf16: each side rounds its outputs to bf16 and the kernels round P and
# dS to bf16 before their products: 4 bf16 ulps of the largest value
FLASH_BF16_REL = 2.0 ** -6
# lse is f32 on both sides (order of summation only)
FLASH_LSE_ATOL = 1e-4
# RMSNorm gradient on the card against plain autograd: one bf16 rounding
# each side plus the order of the row sums, 2 ulps of the largest value
K6_GRAD_REL = 2.0 ** -7
# training parity, f32 on both devices (TF32 off): sums over up to 11008
# terms in other orders; every gradient to 2e-4 of its largest element,
# losses to 1e-5 (one step) and 1e-4 (three AdamW steps)
TRAIN_GRAD_REL = 2e-4
TRAIN_LOSS_RTOL = 1e-5
TRAIN_TRAJ_RTOL = 1e-4

LLAMA_LAYERS = 32
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
DECODE_POSITIONS = [0, 1, 15, 16, 17, 500, 2047, 4095]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*parts):
    print(*parts, flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn`` over ``iters`` launches, timed with
    CUDA events after ``warmup`` launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 1 ------------------------------------------------------------------

def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] name={name} count={count} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(smi)   # the card's name and power limit, as nvidia-smi gives them
    return name, count, smi


def phase_build():
    """One nvcc per CUDA source, in worker threads, while Triton compiles
    K6 by launching it once; all must succeed."""
    from paddle_tpu_torch.ops.hopper import (flash_attention,
                                             paged_attention, rms_norm)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        nvcc = [pool.submit(paged_attention.build),
                pool.submit(flash_attention.build)]
        x = torch.ones(8, 4096, device="cuda", dtype=torch.bfloat16)
        rms_norm.rms_norm_cuda(x, x[0], 1e-5)
        torch.cuda.synchronize()
        t_triton = time.perf_counter() - t0
        nvcc_logs = [f.result() for f in nvcc]
    t_all = time.perf_counter() - t0
    for nvcc_log in nvcc_logs:
        for line in nvcc_log.splitlines():
            if "Compiling entry" in line:
                log(f"[build] ptxas: {line.split(chr(39))[1]}")
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] ptxas: {line.strip()}")
    log(f"[build] seconds={t_all} (triton K6 first launch {t_triton})")


# -- phase 2 and 5: K5 --------------------------------------------------------

def k5_case(gen, *, b, s, h, kv, d, bs, max_blocks, positions, idle=()):
    """Seeded bf16 q and pool with per-row block tables covering each
    row's context; idle rows read scratch block 0 at position 0."""
    dev = torch.device("cuda")
    num_blocks = 1 + b * max_blocks
    q = torch.randn(b, s, h, d, device=dev, generator=gen).bfloat16()
    kbuf = torch.randn(num_blocks, bs, kv, d, device=dev,
                       generator=gen).bfloat16()
    vbuf = torch.randn(num_blocks, bs, kv, d, device=dev,
                       generator=gen).bfloat16()
    perm = torch.randperm(num_blocks - 1, device=dev, generator=gen) + 1
    tables = torch.zeros(b, max_blocks, dtype=torch.int32, device=dev)
    for i, p in enumerate(positions):
        if i in idle:
            continue
        used = min(-(-(p + s) // bs), max_blocks)
        tables[i, :used] = perm[i * max_blocks:i * max_blocks + used]
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return dict(q=q, kbuf=kbuf, vbuf=vbuf, tables=tables, positions=pos,
                kv=kv, d=d)


def k5_bound(c):
    """Least time for the function on these inputs: each row reads its
    visible K/V columns once (min(pos + s, table width)), q, tables and
    positions once, and writes the f32 output once; QK and PV cost 2*d
    operations each per (query head, visible column)."""
    q, kbuf = c["q"], c["kbuf"]
    b, s, h, d = q.shape
    bs, kv = kbuf.shape[1], kbuf.shape[2]
    width = c["tables"].shape[1] * bs
    el = kbuf.element_size()
    nbytes = q.numel() * el + c["tables"].numel() * 4 + b * 4 \
        + b * s * h * d * 4
    ops = 0
    for p in c["positions"].tolist():
        nbytes += 2 * min(p + s, width) * kv * d * el
        ops += sum(4 * d * h * min(p + r + 1, width) for r in range(s))
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k5_library_fn(c):
    """One scaled_dot_product_attention call over the gathered K/V with
    the causal validity mask: the same function as K5, for timing only
    (the gather is done once, outside the timed call)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    q, kbuf, vbuf, tables = c["q"], c["kbuf"], c["vbuf"], c["tables"]
    b, s, h, d = q.shape
    kv = c["kv"]
    t_total = tables.shape[1] * kbuf.shape[1]
    k = kbuf[tables.long()].reshape(b, t_total, kv, d)
    v = vbuf[tables.long()].reshape(b, t_total, kv, d)
    k = k.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(h // kv, dim=2).transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    rows = c["positions"].long()[:, None] + torch.arange(s, device=q.device)
    mask = (torch.arange(t_total, device=q.device)[None, None, :]
            <= rows[:, :, None])[:, None]
    return lambda: sdpa(qt, k, v, attn_mask=mask)


def phase_k5():
    from paddle_tpu_torch.ops.hopper.paged_attention import (
        paged_attend_cuda, paged_attend_reference)

    gen = torch.Generator(device="cuda").manual_seed(1234)
    mb = 4096 // 16
    cases = {
        "decode_b8_h32": k5_case(gen, b=8, s=1, h=32, kv=32, d=128, bs=16,
                                 max_blocks=mb, positions=DECODE_POSITIONS,
                                 idle=(0,)),
        "prefill_s128_pos0": k5_case(gen, b=1, s=128, h=32, kv=32, d=128,
                                     bs=16, max_blocks=mb, positions=[0]),
        "prefill_s128_pos256": k5_case(gen, b=1, s=128, h=32, kv=32, d=128,
                                       bs=16, max_blocks=mb, positions=[256]),
        "ragged_s100": k5_case(gen, b=2, s=100, h=32, kv=32, d=128, bs=16,
                               max_blocks=mb, positions=[37, 300]),
        "gqa_decode_h64_kv8": k5_case(gen, b=8, s=1, h=64, kv=8, d=128,
                                      bs=16, max_blocks=mb,
                                      positions=DECODE_POSITIONS, idle=(0,)),
    }
    results = {}
    for name, c in cases.items():
        args = (c["q"], c["kbuf"], c["vbuf"], c["tables"], c["positions"])
        kw = dict(kv_heads=c["kv"], head_dim=c["d"])
        got = paged_attend_cuda(*args, **kw)
        want = paged_attend_reference(*args, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K5 {name}: non-finite")
        err = (got - want).abs()
        max_err = float(err.max())
        ok = bool((err <= K5_ATOL + K5_RTOL * want.abs()).all())
        log(f"[k5] {name} shape=q{tuple(c['q'].shape)} "
            f"pool{tuple(c['kbuf'].shape)} max_abs_err={max_err} "
            f"tol=atol {K5_ATOL} rtol {K5_RTOL} ok={ok}")
        check(ok, f"K5 {name}: kernel disagrees with the plain version")
        results[name] = dict(case=c, args=args, kw=kw, max_err=max_err)
    return results


def time_k5(results):
    from paddle_tpu_torch.ops.hopper.paged_attention import (
        paged_attend_cuda, paged_attend_reference)

    for name, r in results.items():
        args, kw = r["args"], r["kw"]
        r["ms"] = time_ms(lambda: paged_attend_cuda(*args, **kw))
        r["plain_ms"] = time_ms(lambda: paged_attend_reference(*args, **kw),
                                iters=5, warmup=1)
        r["library_ms"] = time_ms(k5_library_fn(r["case"]))
        r["bound_ms"], r["bound_by"] = k5_bound(r["case"])
        log(f"[time] k5 {name} ms={r['ms']} plain_ms={r['plain_ms']} "
            f"library_ms={r['library_ms']} bound_ms={r['bound_ms']} "
            f"({r['bound_by']}) bound_share={r['bound_ms'] / r['ms']}")
        del r["case"], r["args"]     # the pools: ~0.5 GB per case
    torch.cuda.empty_cache()


# -- phase 3 and 5: K6 --------------------------------------------------------

def phase_k6():
    from paddle_tpu_torch.ops.hopper.rms_norm import (rms_norm_cuda,
                                                      rms_norm_reference)

    gen = torch.Generator(device="cuda").manual_seed(99)
    results = {}
    for rows in (8, 128):
        x = torch.randn(rows, 4096, device="cuda", generator=gen).bfloat16()
        w = (1 + 0.1 * torch.randn(4096, device="cuda",
                                   generator=gen)).bfloat16()
        out, rstd = rms_norm_cuda(x, w, 1e-5)
        want, want_r = rms_norm_reference(x, w, 1e-5)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs()
        max_err = float(err.max())
        ok = bool((err <= K6_ATOL + K6_RTOL * want.float().abs()).all())
        rstd_ok = bool(((rstd - want_r).abs()
                        <= K6_RSTD_RTOL * want_r.abs()).all())
        log(f"[k6] rows={rows} h=4096 bf16 max_abs_err={max_err} "
            f"tol=atol {K6_ATOL} rtol {K6_RTOL} ok={ok} "
            f"rstd_rtol {K6_RSTD_RTOL} rstd_ok={rstd_ok}")
        check(ok and rstd_ok, f"K6 rows={rows}: kernel disagrees with the "
              f"plain version")
        results[f"rows{rows}_h4096"] = dict(x=x, w=w, max_err=max_err)
    return results


def time_k6(results):
    from paddle_tpu_torch.ops.hopper.rms_norm import (rms_norm_cuda,
                                                      rms_norm_reference)

    lib = getattr(torch.nn.functional, "rms_norm", None)
    for name, r in results.items():
        x, w = r["x"], r["w"]
        rows, h = x.shape
        el = x.element_size()
        nbytes = 2 * rows * h * el + h * el + rows * 4
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = 4 * rows * h / PEAK_OPS_S[torch.float32] * 1e3
        r["bound_ms"], r["bound_by"] = ((t_bytes, "bytes") if t_bytes >= t_ops
                                        else (t_ops, "operations"))
        r["ms"] = time_ms(lambda: rms_norm_cuda(x, w, 1e-5), iters=100)
        r["plain_ms"] = time_ms(lambda: rms_norm_reference(x, w, 1e-5),
                                iters=100)
        r["library_ms"] = (None if lib is None else time_ms(
            lambda: lib(x, (h,), w, 1e-5), iters=100))
        log(f"[time] k6 {name} ms={r['ms']} plain_ms={r['plain_ms']} "
            f"library_ms={r['library_ms']} bound_ms={r['bound_ms']} "
            f"({r['bound_by']}) bound_share={r['bound_ms'] / r['ms']}")


def phase_k6_grad():
    """The RMSNorm Function on the card (K6 forward, plain backward)
    carries autograd history, and its dx/dw equal autograd through the
    plain version on the same bf16 inputs, at the training shape."""
    from paddle_tpu_torch.nn.functional import rms_norm
    from paddle_tpu_torch.ops.hopper.rms_norm import rms_norm_reference

    gen = torch.Generator(device="cuda").manual_seed(7)
    h = 4096
    x = torch.randn(TRAIN_BATCH * TRAIN_SEQ, h, device="cuda",
                    generator=gen).bfloat16()
    w = (1 + 0.1 * torch.randn(h, device="cuda", generator=gen)).bfloat16()
    g = torch.randn(x.shape, device="cuda", generator=gen).bfloat16()
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = rms_norm(xa, wa, epsilon=1e-5)
    check(out.grad_fn is not None, "rms_norm on the card has no gradient")
    out.backward(g)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    rms_norm_reference(xb, wb, 1e-5)[0].backward(g)
    torch.cuda.synchronize()
    for name, got, want in (("dx", xa.grad, xb.grad), ("dw", wa.grad,
                                                       wb.grad)):
        err = float((got.float() - want.float()).abs().max())
        tol = K6_GRAD_REL * float(want.float().abs().max())
        log(f"[k6-grad] {name} rows={x.shape[0]} h={h} bf16 max_abs_err="
            f"{err} tol={tol} (2 bf16 ulps of the largest value)")
        check(err <= tol, f"RMSNorm {name} on the card disagrees with "
              f"plain autograd")


# -- phase 4 and 5: flash attention -------------------------------------------

# (name, dtype, b, sq, sk, h, kv, d, causal); the first is the training
# shape, which the timings use
FLASH_CASES = [
    ("causal_b2_s4096_h32_d128_bf16", torch.bfloat16, TRAIN_BATCH, TRAIN_SEQ,
     TRAIN_SEQ, 32, 32, 128, True),
    ("causal_s1024_h32_d128_f32", torch.float32, 1, 1024, 1024, 32, 32, 128,
     True),
    ("gqa_h32_kv8_s2048_bf16", torch.bfloat16, 1, 2048, 2048, 32, 8, 128,
     True),
    ("noncausal_sq256_sk1024_bf16", torch.bfloat16, 2, 256, 1024, 32, 32, 128,
     False),
    ("ragged_s200_h32_kv8_bf16", torch.bfloat16, 2, 200, 200, 32, 8, 128,
     True),
    ("d64_g1_s1024_h16_bf16", torch.bfloat16, 1, 1024, 1024, 16, 16, 64, True),
]


def phase_flash():
    """Each case: the forward kernel against the plain forward (out,
    lse), then the dq and dkv kernels against the plain FA2 backward
    (dq, dk, dv), both backward versions fed the plain forward's out and
    lse so that each kernel is judged on its own."""
    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(4321)
    results = {}
    for name, dt, b, sq, sk, h, kv, d, causal in FLASH_CASES:
        def rnd(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(dt)

        q, k, v = rnd(b, sq, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d)
        do = rnd(b, sq, h, d)
        scale = 1.0 / d ** 0.5
        out, lse = fa.flash_attention_fwd_cuda(q, k, v, causal, scale)
        want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                              scale)
        grads = fa.flash_attention_bwd_cuda(q, k, v, want_out, want_lse, do,
                                            causal, scale)
        want_grads = fa.flash_attention_bwd_reference(
            q, k, v, want_out, want_lse, do, causal, scale)
        torch.cuda.synchronize()
        errs = {}
        for key, got, want in zip(("out", "dq", "dk", "dv"),
                                  (out, *grads), (want_out, *want_grads)):
            check(bool(torch.isfinite(got).all()), f"flash {name}: {key} "
                  f"not finite")
            err = float((got.float() - want.float()).abs().max())
            tol = (FLASH_F32_ATOL if dt == torch.float32 else
                   FLASH_BF16_REL * float(want.float().abs().max()))
            errs[key] = err
            log(f"[flash] {name} {key} max_abs_err={err} tol={tol}")
            check(err <= tol, f"flash {name}: {key} disagrees with the "
                  f"plain version")
        errs["lse"] = float((lse - want_lse).abs().max())
        log(f"[flash] {name} lse max_abs_err={errs['lse']} tol="
            f"{FLASH_LSE_ATOL}")
        check(errs["lse"] <= FLASH_LSE_ATOL, f"flash {name}: lse disagrees")
        results[name] = errs
        if not results.get("main"):
            delta = (do.float() * want_out.float()).sum(-1).transpose(
                1, 2).contiguous()
            results["main"] = dict(q=q, k=k, v=v, do=do, out=want_out,
                                   lse=want_lse, delta=delta, causal=causal,
                                   scale=scale, name=name)
        del q, k, v, do, out, lse, want_out, want_lse, grads, want_grads
    torch.cuda.empty_cache()
    return results


def flash_bound(m, kernel):
    """Least time for one kernel's function on the main case: operations
    (each product of an ``sq x sk`` score tile with d is 2·sq·sk·d per
    head: the forward needs QK^T and PV; dq needs QK^T, dO V^T and dS K;
    dkv needs K Q^T, V dO^T, P^T dO and dS^T Q; causal halves them) at
    the input type's peak, or bytes (each input read once, each output
    written once) at the HBM rate, whichever is larger."""
    q, k = m["q"], m["k"]
    b, sq, h, d = q.shape
    sk = k.shape[1]
    el = q.element_size()
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kernel]
    ops = products * 2 * b * h * sq * sk * d / (2 if m["causal"] else 1)
    qo = q.numel() * el
    kv_bytes = 2 * k.numel() * el
    rows = b * h * sq * 4                     # one f32 per row: lse, delta
    nbytes = {"fwd": 2 * qo + kv_bytes + rows,
              "dq": 3 * qo + kv_bytes + 2 * rows,
              "dkv": 2 * qo + 2 * kv_bytes + 2 * rows}[kernel]
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_flash(results):
    """Times on the main case (the training shape). The plain backward
    and SDPA's backward compute dq, dk and dv together; the plain and
    library times of dq and dkv are those of the whole backward."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    m = results["main"]
    q, k, v, do = m["q"], m["k"], m["v"], m["do"]
    causal, scale = m["causal"], m["scale"]
    bwd_args = (q, k, v, do, m["lse"], m["delta"], causal, scale)
    plain_fwd = time_ms(lambda: fa.flash_attention_fwd_reference(
        q, k, v, causal, scale), iters=2, warmup=1)
    plain_bwd = time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, m["out"], m["lse"], do, causal, scale), iters=2, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    lib_fwd = time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal))
    lib_out = sdpa(qt, kt, vt, is_causal=causal)
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True))
    timing = {
        "fwd": dict(ms=time_ms(lambda: fa.flash_attention_fwd_cuda(
            q, k, v, causal, scale)), plain_ms=plain_fwd, library_ms=lib_fwd),
        "dq": dict(ms=time_ms(lambda: fa.flash_attention_dq_cuda(*bwd_args)),
                   plain_ms=plain_bwd, library_ms=lib_bwd),
        "dkv": dict(ms=time_ms(lambda: fa.flash_attention_dkv_cuda(
            *bwd_args)), plain_ms=plain_bwd, library_ms=lib_bwd),
    }
    for kernel, r in timing.items():
        r["bound_ms"], r["bound_by"] = flash_bound(m, kernel)
        log(f"[time] flash {kernel} {m['name']} ms={r['ms']} plain_ms="
            f"{r['plain_ms']} library_ms={r['library_ms']} bound_ms="
            f"{r['bound_ms']} ({r['bound_by']}) bound_share="
            f"{r['bound_ms'] / r['ms']}")
    log(f"[time] flash backward pair dq+dkv ms="
        f"{timing['dq']['ms'] + timing['dkv']['ms']} sdpa_backward_ms="
        f"{lib_bwd} (dq, dk, dv in one call)")
    del results["main"], qt, kt, vt, lib_out
    torch.cuda.empty_cache()
    return timing


# -- phase 6: parity at full width --------------------------------------------

def _dense_last_logits(model, tokens):
    """Dense-cache forward of ``tokens`` in one prefill: last-row f32
    logits (for the top-2 gap of a mismatch report)."""
    cfg = model.config
    d = cfg.hidden_size // cfg.num_attention_heads
    caches = [(torch.zeros(1, len(tokens), cfg.num_key_value_heads, d,
                           device="cuda"),
               torch.zeros(1, len(tokens), cfg.num_key_value_heads, d,
                           device="cuda"))
              for _ in range(cfg.num_hidden_layers)]
    with torch.no_grad():
        logits, _ = model(torch.tensor([tokens], device="cuda"),
                          kv_caches=caches, position_offset=0)
    return logits[0, -1].float()


def phase_parity():
    from paddle_tpu_torch import LlamaConfig, LlamaForCausalLM, ServingEngine

    # f32 products run in full f32, not TF32, on both paths
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    model = LlamaForCausalLM(cfg, seed=0)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 17, 29, 40)]
    engine = ServingEngine.from_model(model)
    rids = [engine.add_request(p, max_new_tokens=8) for p in prompts]
    done = engine.run()
    for rid, p in zip(rids, prompts):
        got = done[rid].output_ids
        want = model.generate(torch.tensor([p], device="cuda"),
                              max_new_tokens=8)[0, len(p):].tolist()
        if got != want:
            step = next(i for i, (a, b) in enumerate(zip(got, want))
                        if a != b)
            top2 = torch.topk(_dense_last_logits(model, p + want[:step]), 2)
            gap = float(top2.values[0] - top2.values[1])
            log(f"[parity] MISMATCH request {rid} at step {step}: engine "
                f"{got} dense {want} top-2 logit gap {gap}")
            raise SmokeFailure("engine and dense greedy tokens differ")
        log(f"[parity] request {rid} prompt_len={len(p)} tokens={got} "
            f"equal=True")
    log(f"[parity] llama2_7b width, 2 layers, f32: {len(prompts)} requests "
        f"equal (engine dispatches={engine.dispatches})")
    del model, engine
    torch.cuda.empty_cache()


# -- phase 7: full Llama-2-7B serving -----------------------------------------

def phase_serving():
    from paddle_tpu_torch import LlamaConfig, LlamaForCausalLM, ServingEngine
    from paddle_tpu_torch.ops.hopper.paged_attention import paged_attend_cuda
    from paddle_tpu_torch.ops.hopper.rms_norm import rms_norm_cuda
    from paddle_tpu_torch.serving.robustness import now_s

    torch.cuda.reset_peak_memory_stats()
    cfg = LlamaConfig.llama2_7b(dtype="bfloat16")
    check(cfg.num_hidden_layers == LLAMA_LAYERS, "expected 32 layers")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=0)
    # warm-up outside the timed run (first cuBLAS calls, allocator):
    # one request through a throwaway engine with a small pool
    warm = ServingEngine.from_model(model, block_size=16, max_slots=8,
                                    prefill_chunk=128, pool_blocks=64)
    warm.add_request(list(range(1, 129)), max_new_tokens=2)
    warm.run()
    del warm
    engine = ServingEngine.from_model(model, block_size=16, max_slots=8,
                                      prefill_chunk=128)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    log(f"[serve] model+pool setup seconds={time.perf_counter() - t0} "
        f"pool_blocks={engine.pool.num_blocks} weight_bytes={weight_bytes}")

    finite = []
    dispatch = engine._dispatch

    def checked_dispatch(*args):
        out = dispatch(*args)
        finite.append(bool(np.isfinite(out).all()))
        return out

    engine._dispatch = checked_dispatch
    rng = np.random.default_rng(7)
    lengths = rng.integers(128, 513, 8)
    t_arrival = now_s()
    rids = [engine.add_request(rng.integers(0, cfg.vocab_size, n).tolist(),
                               max_new_tokens=64, arrival_s=t_arrival)
            for n in lengths]
    paged_attend_cuda.launches = 0
    rms_norm_cuda.launches = 0
    t0 = time.perf_counter()
    done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5, k6 = paged_attend_cuda.launches, rms_norm_cuda.launches
    m = engine.metrics.snapshot()
    out_tokens = sum(len(done[r].output) for r in rids)
    log(f"[serve] prompts={lengths.tolist()} max_new=64 wall_s={wall} "
        f"output_tok_s={out_tokens / wall} steps={m['steps']} "
        f"dispatches={engine.dispatches}")
    log(f"[serve] ttft_p50_s={m['ttft_p50_s']} ttft_p95_s={m['ttft_p95_s']} "
        f"tpot_p50_s={m['tpot_p50_s']} tpot_p95_s={m['tpot_p95_s']} "
        f"mean_batch_occupancy={m['mean_batch_occupancy']} "
        f"preemptions={m['preemptions']}")
    log(f"[serve] phase_seconds={json.dumps(m['phase_seconds'])}")
    log(f"[serve] peak_memory_bytes={torch.cuda.max_memory_allocated()}")
    log(f"[serve] launches k5={k5} (32 x {engine.dispatches} = "
        f"{LLAMA_LAYERS * engine.dispatches}) k6={k6} (65 x "
        f"{engine.dispatches} = {(2 * LLAMA_LAYERS + 1) * engine.dispatches})")
    check(sorted(done) == sorted(rids), "not every request finished")
    check(all(len(done[r].output) == 64 for r in rids),
          "a request finished with other than 64 tokens")
    check(finite and all(finite), "non-finite logits in the serving run")
    check(k5 == LLAMA_LAYERS * engine.dispatches,
          f"K5 launches {k5} != 32 x {engine.dispatches}")
    check(k6 == (2 * LLAMA_LAYERS + 1) * engine.dispatches,
          f"K6 launches {k6} != 65 x {engine.dispatches}")
    profile_window(engine, cfg.vocab_size)
    # the wrapper holds the engine's bound method, a reference cycle:
    # drop it so the weights and the pool (~30 GB) are freed here
    del engine._dispatch
    del model, engine
    torch.cuda.empty_cache()
    return k5, k6


KERNEL_FAMILIES = (("k5_paged_attention", ("paged_attend_kernel",)),
                   ("k6_rms_norm", ("rms_norm_fwd",)),
                   ("matmul", ("nvjet", "gemm", "cutlass", "xmma")))


def device_ms_by_family(prof, families, n, others=None):
    """Device milliseconds per unit (``n`` units in the window) by kernel
    family, from a torch.profiler window. ``others``, a dict, collects
    the kernels of the "other" family by name."""
    device_ms = dict.fromkeys([f for f, _ in families] + ["other"], 0.0)
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        # device-side entries (kernels, copies) carry no host time; the
        # aten ops that launched them do and are skipped, so nothing is
        # counted twice
        if dev_us <= 0 or evt.self_cpu_time_total > 0:
            continue
        fam = next((f for f, keys in families
                    if any(k in evt.key for k in keys)), "other")
        device_ms[fam] += dev_us / 1e3 / n
        if fam == "other" and others is not None:
            others[evt.key] = others.get(evt.key, 0.0) + dev_us / 1e3 / n
    return device_ms


def profile_window(engine, vocab, steps=4):
    """Where a serving step's time goes, on a fresh 8-request batch:
    ``steps`` engine steps timed on the host clock without the profiler,
    then ``steps`` more under torch.profiler (whose own host cost makes
    its wall time useless). Prints device time per dispatch by kernel
    family and the device's idle share: 1 - device time per dispatch
    (profiled steps) / wall time per dispatch (unprofiled steps)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(11)
    for n in rng.integers(128, 513, 8):
        engine.add_request(rng.integers(0, vocab, n).tolist(),
                           max_new_tokens=32)
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    d0, t0 = engine.dispatches, time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (engine.dispatches - d0)
    d0 = engine.dispatches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    n_prof = engine.dispatches - d0
    device_ms = device_ms_by_family(prof, KERNEL_FAMILIES, n_prof)
    busy_ms = sum(device_ms.values())
    log(f"[profile] per dispatch: wall_ms={wall_ms} (unprofiled) "
        f"device_busy_ms={busy_ms} device_idle_share={1 - busy_ms / wall_ms}"
        f" ({n_prof} profiled dispatches)")
    log(f"[profile] device_ms_per_dispatch_by_family={json.dumps(device_ms)}")
    engine.run()


# -- phase 8: training parity at full width -----------------------------------

def _max_rel_err(got, want):
    err = float((got.detach().cpu().float() - want.float()).abs().max())
    return err / max(float(want.float().abs().max()), 1e-30)


def phase_train_parity():
    """Llama-2-7B widths, 2 layers, f32, TF32 off: one forward/backward
    on the card (flash and K6 kernels) against the CPU (plain versions)
    on the same seeded weights, loss and every gradient; then 3 AdamW
    TrainSteps on each device, the losses compared step by step."""
    from paddle_tpu_torch import (LlamaConfig, LlamaForCausalLM, TrainStep,
                                  llama_loss_fn, load_reference_state)
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    card = LlamaForCausalLM(cfg, seed=0)
    host = LlamaForCausalLM(cfg, device="cpu", seed=1)
    load_reference_state(host, {n: p.detach().cpu().numpy()
                                for n, p in card.named_parameters()})
    rng = np.random.default_rng(21)
    ids = rng.integers(0, cfg.vocab_size, (1, 257))
    batch = (ids[:, :-1], ids[:, 1:])
    losses = {}
    for dev, model in (("cuda", card), ("cpu", host)):
        i, lab = (torch.tensor(a, device=dev) for a in batch)
        loss = llama_loss_fn(model, i, lab)
        loss.backward()
        losses[dev] = float(loss.detach())
    err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    log(f"[train-parity] llama2_7b width, 2 layers, f32, s=256: loss card="
        f"{losses['cuda']} cpu={losses['cpu']} rel_err={err} tol "
        f"{TRAIN_LOSS_RTOL}")
    check(err <= TRAIN_LOSS_RTOL, "training loss differs card vs CPU")
    host_params = dict(host.named_parameters())
    worst = ("", 0.0)
    for n, p in card.named_parameters():
        e = _max_rel_err(p.grad, host_params[n].grad)
        worst = max(worst, (n, e), key=lambda t: t[1])
        check(e <= TRAIN_GRAD_REL, f"gradient of {n} differs card vs CPU: "
              f"{e} of its largest element")
    log(f"[train-parity] all {len(host_params)} gradients within "
        f"{TRAIN_GRAD_REL} of their largest element; worst {worst[0]} "
        f"{worst[1]}")
    traj = {}
    for dev, model in (("cuda", card), ("cpu", host)):
        i, lab = (torch.tensor(a, device=dev) for a in batch)
        # a small rate keeps the loss well away from 0, where a relative
        # comparison says nothing (at 1e-4 the 256 tokens are learnt in
        # two steps)
        step = TrainStep(model, AdamW(learning_rate=1e-6), llama_loss_fn)
        traj[dev] = [float(step(i, lab)) for _ in range(3)]
    rel = [abs(a - b) / abs(b) for a, b in zip(traj["cuda"], traj["cpu"])]
    log(f"[train-parity] 3 AdamW steps: card={traj['cuda']} cpu="
        f"{traj['cpu']} rel_err={rel} tol {TRAIN_TRAJ_RTOL} "
        f"seconds={time.perf_counter() - t0}")
    check(max(rel) <= TRAIN_TRAJ_RTOL, "loss trajectory differs card vs CPU")
    check(traj["cuda"][-1] < traj["cuda"][0], "parity loss did not fall")
    del card, host
    torch.cuda.empty_cache()


# -- phase 9: training at full width ------------------------------------------

TRAIN_FAMILIES = (("flash_fwd", ("flash_fwd_kernel",)),
                  ("flash_dq", ("flash_dq_kernel",)),
                  ("flash_dkv", ("flash_dkv_kernel",)),
                  ("k6_rms_norm", ("rms_norm_fwd",)),
                  ("matmul", ("nvjet", "gemm", "cutlass", "xmma")))


def _train_counts():
    from paddle_tpu_torch.ops.hopper import flash_attention as fa
    from paddle_tpu_torch.ops.hopper.rms_norm import rms_norm_cuda

    return dict(fwd=fa.flash_attention_fwd_cuda.launches,
                dq=fa.flash_attention_dq_cuda.launches,
                dkv=fa.flash_attention_dkv_cuda.launches,
                k6=rms_norm_cuda.launches)


def _reset_train_counts():
    from paddle_tpu_torch.ops.hopper import flash_attention as fa
    from paddle_tpu_torch.ops.hopper.rms_norm import rms_norm_cuda

    for fn in (fa.flash_attention_fwd_cuda, fa.flash_attention_dq_cuda,
               fa.flash_attention_dkv_cuda, rms_norm_cuda):
        fn.launches = 0


def phase_training(warmup=2, timed=5):
    """Llama-2-7B widths (hidden 4096, intermediate 11008, 32 heads of
    128, vocab 32000) cut to 8 layers, bf16 with f32 AdamW masters, a
    fixed random batch of 2 x 4096 tokens, as bench.py's 7B-layer bench
    runs it. Every step must launch exactly 8 flash forward, 8 dq and 8
    dkv kernels and 17 K6 forwards; the loss must stay finite and fall."""
    from paddle_tpu_torch import (LlamaConfig, LlamaForCausalLM, TrainStep,
                                  llama_loss_fn)
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated()
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=TRAIN_LAYERS,
                                fused_head_loss=True, dtype="bfloat16")
    model = LlamaForCausalLM(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    mem_weights = torch.cuda.memory_allocated()
    step = TrainStep(model, AdamW(learning_rate=1e-4, multi_precision=True),
                     llama_loss_fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                        device="cuda", generator=gen)
    ids, labels = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    want = dict(fwd=TRAIN_LAYERS, dq=TRAIN_LAYERS, dkv=TRAIN_LAYERS,
                k6=2 * TRAIN_LAYERS + 1)
    losses, seconds = [], []
    _reset_train_counts()
    for i in range(warmup + timed):
        before = _train_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(ids, labels))     # waits for the step
        seconds.append(time.perf_counter() - t0)
        losses.append(loss)
        if i == 0:
            # weights, f32 masters and moments: what outlives a step
            mem_state = torch.cuda.memory_allocated()
        after = _train_counts()
        got = {k: after[k] - before[k] for k in want}
        check(got == want, f"training step {i}: launches {got} != {want}")
    counts = _train_counts()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = sum(seconds[warmup:]) / timed
    tok_s = tokens / step_s
    mfu = 6 * n_params * tok_s / PEAK_OPS_S[torch.bfloat16]
    log(f"[train] llama2_7b widths, {TRAIN_LAYERS} layers, bf16, AdamW "
        f"multi_precision, batch {TRAIN_BATCH}x{TRAIN_SEQ}: params="
        f"{n_params} losses={losses}")
    log(f"[train] step_ms={step_s * 1e3} (mean of {timed} after {warmup} "
        f"warm-up; each {[t * 1e3 for t in seconds]}) tokens_per_s={tok_s} "
        f"mfu={mfu} (6*N*tokens/s over 989e12)")
    log(f"[train] peak_memory_bytes={torch.cuda.max_memory_allocated()} "
        f"(allocated: before the model {mem_base}, with the weights "
        f"{mem_weights}, after the first step {mem_state})")
    log(f"[train] launches over {warmup + timed} steps: {counts} (per step "
        f"{want})")
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] < losses[0], f"training loss did not fall: {losses}")
    profile_train_window(step, ids, labels, step_s * 1e3)
    del model, step
    torch.cuda.empty_cache()
    return counts


def profile_train_window(step, ids, labels, wall_ms, steps=2):
    """Device time per training step by kernel family under
    torch.profiler, and the device's idle share against the unprofiled
    step time ``wall_ms``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(ids, labels)
        torch.cuda.synchronize()
    others = {}
    device_ms = device_ms_by_family(prof, TRAIN_FAMILIES, steps, others)
    busy_ms = sum(device_ms.values())
    log(f"[train-profile] per step: wall_ms={wall_ms} (unprofiled) "
        f"device_busy_ms={busy_ms} device_idle_share={1 - busy_ms / wall_ms}"
        f" ({steps} profiled steps)")
    log(f"[train-profile] device_ms_per_step_by_family="
        f"{json.dumps(device_ms)}")
    top = sorted(others.items(), key=lambda kv: -kv[1])[:10]
    log(f"[train-profile] largest of other, ms per step: "
        f"{json.dumps([(k[:90], v) for k, v in top])}")


def kernel_entry(name, route, source, replaces, launches, results, key):
    r = results[key]
    max_err = max(v["max_err"] for v in results.values())
    return timed_entry(name, route, source, replaces, launches, max_err, r,
                       key)


def timed_entry(name, route, source, replaces, launches, max_err, r, shape):
    return {"name": name, "route": route, "source": source,
            "replaces": replaces, "status": "ok", "shape": shape,
            "launches": launches, "max_abs_err": max_err, "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    name, count, _ = phase_device()
    phase_build()
    k5 = phase_k5()
    k6 = phase_k6()
    phase_k6_grad()
    flash = phase_flash()
    time_k5(k5)
    time_k6(k6)
    flash_times = time_flash(flash)
    phase_parity()
    k5_launches, k6_launches = phase_serving()
    phase_train_parity()
    train = phase_training()
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    pallas = "paddle_tpu/ops/pallas/flash_attention.py"
    shape = FLASH_CASES[0][0]
    kernels = [
        kernel_entry("paged_attention", "cuda",
                     "paddle_tpu_torch/csrc/paged_attention.cu",
                     "paddle_tpu/ops/pallas/paged_attention.py:256",
                     k5_launches, k5, "decode_b8_h32"),
        kernel_entry("rms_norm", "triton",
                     "paddle_tpu_torch/ops/hopper/rms_norm.py",
                     "paddle_tpu/ops/pallas/rms_norm.py:55",
                     k6_launches, k6, "rows8_h4096"),
        dict(timed_entry("flash_attention_fwd", "cuda", src, f"{pallas}:298",
                         train["fwd"], max(max(e["out"], e["lse"])
                                           for e in flash.values()),
                         flash_times["fwd"], shape),
             also_replaces=[f"{pallas}:172"]),
        dict(timed_entry("flash_attention_dq", "cuda", src, f"{pallas}:673",
                         train["dq"], max(e["dq"] for e in flash.values()),
                         flash_times["dq"], shape),
             also_replaces=[f"{pallas}:567"]),
        dict(timed_entry("flash_attention_dkv", "cuda", src, f"{pallas}:703",
                         train["dkv"], max(max(e["dk"], e["dv"])
                                           for e in flash.values()),
                         flash_times["dkv"], shape),
             also_replaces=[f"{pallas}:610"]),
    ]
    log(f"[done] seconds={time.perf_counter() - t_start}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
