#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``paddle_tpu_torch``) on one NVIDIA
H100: the quickest proof that the port builds, runs and is right on the
card. Run from the repository root with ``python3 chip_smoke.py``;
``python3 chip_smoke.py --k8-bwd`` builds and runs only K8's backward
at ResNet-50's three shapes (check, timings, device time by part), the
quick loop for that kernel; ``--k8-fwd`` does the same for K8's forward
(check, bitwise repeatability, timings beside ``F.conv2d``, the plain
version and the bound, device ms of the band kernel and the reduction),
and ``--k8-fwd --root DIR`` runs that loop on the port of another
checkout unpacked into DIR. ``python3 chip_smoke.py --k5`` does the same
for K5 at all its cases (check, timings, device ms of its split and
merge kernels, host microseconds per call, both bodies at each span
widths); ``--k5 --root DIR`` runs it on the port of another checkout
(an earlier commit's, unpacked into DIR) for a comparison on one card.
``python3 chip_smoke.py --flash-fwd [--root DIR]`` is the same loop for
the flash forward (K1/K3): the build's ptxas report, out and lse against
the plain version at every bf16 case and the 128-row tile edges, two
calls bitwise equal, and timings beside SDPA and the bound.
``--flash-bwd [--root DIR]`` does the same for the backward (K2/K4): dq,
dk and dv (also row by row) at the same cases, two calls bitwise equal,
and the times of dq, dkv, their sum and the whole backward (delta
included) beside SDPA's backward and the bound.
``python3 chip_smoke.py --k7-fwd [--root DIR]`` is the same loop for K7's
forward: the build's ptxas report, y, s1 and s2 against the plain version
at the main path's four K7 shapes and at ragged rows with and without the
prologue, two calls bitwise equal, the times back to back and by CUDA-graph
replay beside ``torch.matmul``, the plain version and the bound, and the
device ms of each part (forward kernel; reduction).
``python3 chip_smoke.py --k7-bwd [--root DIR]`` is the same loop for K7's
backward: the build's ptxas report, dx, dw, da and db against the plain
version at the main path's four K7 shapes and at ragged rows for each
design (one pass, three passes), two calls bitwise equal, the times
beside ``convolution_backward``, the plain version and the bound, and
the device ms of each part (one pass; dyc, dx, dw; reductions).
``python3 chip_smoke.py --norms [--root DIR]`` is the same loop for K6
(RMSNorm forward) and K9 (BatchNorm statistics): the builds' ptxas
report, every check of phases 3 and 10 on both kernels (K6 at its three
main shapes, in f32 and f16, at widths 2048, 8192, one that is not a
multiple of 8 and one above 8192; K9 at its four main shapes and the
ragged, 8-row, 128-channel and f16 cases), two calls bitwise equal, the
times back to back and by CUDA-graph replay beside the library call,
the plain version and the bound, and the wrapper's host microseconds per
call.

Phases, in order; each one checks its own results and any failure ends
the run with a non-zero exit code and no result line:

1. Device: name, count, ``nvidia-smi`` name and power limit; build the
   kernels from the checkout's sources (one nvcc per CUDA source, all
   six started together).
2. K5 (ragged paged attention, CUDA) against its plain version on the
   same bf16 pool: decode at mixed depths with an idle row, prefill at
   position 0 and 256, a ragged 100-row chunk, GQA decode, decode at
   phase 7's depths, rows whose horizon ends one column before, on and
   after a span boundary with the full table and an idle row, and an f32
   pool; two calls give equal bits (the fixed-order merge).
3. K6 (RMSNorm forward, CUDA) against its plain version: 8, 128 and
   8192 rows x 4096 in bf16, f32 and f16 at 128 x 4096, widths 2048,
   8192, 4100 (not a multiple of 8) and 16384 (the shared-memory path),
   two calls bitwise equal; the RMSNorm autograd Function's dx/dw on the
   card against plain autograd.
4. The flash-attention forward, dq and dkv kernels (CUDA) against their
   plain versions: out, lse, dq, dk, dv for causal s=4096 bf16 (the
   training shape), causal s=1024 f32, GQA 32/8, non-causal 256 x 1024,
   a ragged s=200 and d=64; bf16 out, dq, dk and dv also row by row, to
   4 (out) or 8 ulps of each row's largest value; a second bf16
   backward call gives equal bits.
5. Timings of every kernel with CUDA events: kernel, plain version, one
   PyTorch library call for the same function, and the bound (K6 also by
   CUDA-graph replay, at the training shape, 8192 x 4096, and as the
   wrapper's host microseconds per call).
6. Serving parity at Llama-2-7B width, 2 layers, f32: engine greedy
   tokens (kernels) equal dense ``generate`` tokens.
7. Serving at full Llama-2-7B (bf16, 32 layers): 8 requests through the
   engine; throughput, TTFT/TPOT, peak memory, exact launch counts; then
   a short torch.profiler window: device time by kernel family and the
   device's idle share; then one prefill and one decode-only dispatch
   from the window replayed under the profiler, by family and with K5's
   split and merge kernels apart.
8. Training parity at Llama-2-7B width, 2 layers, f32, b=1, s=256: the
   loss and every parameter's gradient on the card (kernels) against
   the CPU (plain versions), then a 3-step TrainStep loss trajectory.
9. Training at Llama-2-7B widths, 8 layers, bf16, AdamW with f32
   masters, batch 2 x 4096: 2 warm-up and 5 timed TrainSteps; step
   time, tokens/s, MFU, peak memory, exact launch counts per step, a
   falling loss; then a torch.profiler window as for serving.
10. K7 and K8 (fused conv + BatchNorm, CUDA) forward and backward and
    K9 (BatchNorm statistics, CUDA) against their plain versions at
    ResNet-50 shapes (batch 256, 224^2, bf16): K7 with the prologue
    (layer 1's second 1x1, 64 -> 256, and layer 2's, 128 -> 512) and
    without (layer 4's first, 2048 -> 512, and layer 3's, 1024 -> 256;
    its backward twice, for equal bits), K8 at layer 1 (56^2, 64),
    layer 3 (14^2, 256) and layer 2 (28^2, 128) (its forward also
    twice, for equal bits), K9 at its four main shapes (802,816 x 256 to
    12,544 x 2048) and at ragged rows, 8 rows, 128 channels and f16 (each
    twice, for equal bits); then their timings beside a PyTorch call and
    the bound (K9 also by CUDA-graph replay), and K7's and
    K8's device time by part (K7: forward, backward one pass or dyc, dx,
    dw, reductions; K8 forward: band kernel, reduction; K8 backward:
    dyc, dw, dx, reductions).
11. One layer-1 bottleneck (256 -> 64 -> 256, 56^2, batch 8, bf16, both
    ResNet flags on): the card (kernels) against the CPU (plain
    versions), and the fused composition against the default one on
    the card.
12. ResNet-50 training at batch 256, 224^2, bf16 with f32 Momentum
    masters, both flags on: 2 warm-up and 5 timed TrainSteps with exact
    launch counts per step and a falling loss; a torch.profiler window;
    then the same step with both flags off (cuDNN and plain BatchNorm)
    as the whole-step yardstick.
13. One ``kernels`` JSON line.
14. The result line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or the JAX package. Without a CUDA device it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import functools
import json
import os
import re
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
# K6 against its plain version, both in f32 over the same inputs: the
# output to two ulps of its dtype (one rounding each side plus the order
# of the row's sum) as atol and rtol alike, f32 to 1e-5; f32 rstd to 1e-5
K6_TOL = {torch.bfloat16: 1.6e-2, torch.float16: 2e-3, torch.float32: 1e-5}
K6_RSTD_RTOL = 1e-5

# flash attention: f32 sums in other orders on both sides
FLASH_F32_ATOL = 1e-4
# bf16: each side rounds its outputs to bf16 and the kernels round P and
# dS to bf16 before their products: 4 bf16 ulps of the largest value, and
# of each row's largest value for out (flash_row_err; sound kernels read
# one ulp, 2^-7, on the worst row)
FLASH_BF16_REL = 2.0 ** -6
# dq, dk and dv row by row: 8 bf16 ulps of each row's largest value. dS
# rounded to bf16 moves a row whose terms cancel by up to two ulps: sound
# kernels (the mma.sync ones and the wgmma ones alike) read 1/116 on the
# worst dq row at the training shape and 2^-7 elsewhere
FLASH_GRAD_ROW_REL = 2.0 ** -5
# the least row scale of dq, dk and dv, as a share of the tensor's largest
# value: causal dq's first row is zero in exact arithmetic (one key, so
# P = 1 and dS = dP - delta = 0) and rounding noise on both sides
FLASH_ROW_FLOOR = 2.0 ** -10
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

# K6 at the training shape: batch 2 x 4096 tokens
K6_TRAIN_ROWS = 8192
# K6 beyond the main path's shapes (rows, h, dtype): f32 and f16, widths
# 2048 and 8192 (the widest row held in registers), 1000 in f32 (a masked
# tail of 16-byte packs), 4100 (not a multiple of 8: element by element),
# 16384 and 32768 (the widest, in f32) staged in shared memory
K6_EXTRA_CASES = [(128, 4096, torch.float32), (128, 4096, torch.float16),
                  (128, 2048, torch.bfloat16), (128, 8192, torch.bfloat16),
                  (64, 1000, torch.float32), (128, 4100, torch.bfloat16),
                  (64, 16384, torch.bfloat16), (8, 32768, torch.float32)]
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


def time_ms_graph(fn, iters=20, replays=5):
    """Mean milliseconds of ``fn`` on the card per call: ``iters`` calls
    captured in one CUDA graph, replayed ``replays`` times between CUDA
    events. For a call shorter than its own host enqueue, back-to-back
    timing (:func:`time_ms`) measures the host; a replay leaves the
    host's launch cost out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


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
    """One nvcc per CUDA source, all started together in worker threads;
    all must succeed."""
    from paddle_tpu_torch.ops.hopper import (bn_stats, flash_attention,
                                             paged_attention, resnet_unit,
                                             rms_norm)

    t0 = time.perf_counter()
    builds = (paged_attention.build, flash_attention.build, resnet_unit.build,
              resnet_unit.build_conv3x3, rms_norm.build, bn_stats.build)
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        nvcc_logs = list(pool.map(lambda build: build(), builds))
    t_all = time.perf_counter() - t0
    for nvcc_log in nvcc_logs:
        for line in nvcc_log.splitlines():
            if "Compiling entry" in line:
                log(f"[build] ptxas: {line.split(chr(39))[1]}")
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] ptxas: {line.strip()}")
    log(f"[build] seconds={t_all}")


# -- phase 2 and 5: K5 --------------------------------------------------------

def k5_case(gen, *, b, s, h, kv, d, bs, max_blocks, positions, idle=(),
            dtype=torch.bfloat16):
    """Seeded q and pool (bf16 unless said) with per-row block tables
    covering each row's context; idle rows read scratch block 0 at
    position 0."""
    dev = torch.device("cuda")
    num_blocks = 1 + b * max_blocks
    q = torch.randn(b, s, h, d, device=dev, generator=gen).to(dtype)
    kbuf = torch.randn(num_blocks, bs, kv, d, device=dev,
                       generator=gen).to(dtype)
    vbuf = torch.randn(num_blocks, bs, kv, d, device=dev,
                       generator=gen).to(dtype)
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


def serving_depths():
    """Decode positions at phase 7's depths: its 8 seeded prompt lengths
    (128-512) half way through their 64 new tokens."""
    lengths = np.random.default_rng(7).integers(128, 513, 8)
    return (lengths + 32).tolist()


def k5_cases(gen):
    """Every K5 case: name -> inputs."""
    mb = 4096 // 16
    mha = dict(h=32, kv=32, d=128, bs=16, max_blocks=mb)
    return {
        "decode_b8_h32": k5_case(gen, b=8, s=1, positions=DECODE_POSITIONS,
                                 idle=(0,), **mha),
        "prefill_s128_pos0": k5_case(gen, b=1, s=128, positions=[0], **mha),
        "prefill_s128_pos256": k5_case(gen, b=1, s=128, positions=[256],
                                       **mha),
        "ragged_s100": k5_case(gen, b=2, s=100, positions=[37, 300], **mha),
        "gqa_decode_h64_kv8": k5_case(gen, b=8, s=1, h=64, kv=8, d=128,
                                      bs=16, max_blocks=mb,
                                      positions=DECODE_POSITIONS, idle=(0,)),
        "decode_serving_depths": k5_case(gen, b=8, s=1,
                                         positions=serving_depths(), **mha),
        # horizons one column before, on and after the span boundaries at
        # 256 and 512 columns, the full table, an idle row
        "decode_split_edges": k5_case(
            gen, b=8, s=1, positions=[254, 255, 256, 510, 511, 512, 4095, 0],
            idle=(7,), **mha),
        "decode_b8_full_table": k5_case(gen, b=8, s=1, positions=[4095] * 8,
                                        **mha),
        "decode_b8_h32_f32": k5_case(gen, b=8, s=1,
                                     positions=DECODE_POSITIONS, idle=(0,),
                                     dtype=torch.float32, **mha),
    }


def k5_check(name, got, want):
    """Max abs error of a K5 output against the plain version; fails
    outside K5_ATOL + K5_RTOL * |want| or on a non-finite value."""
    check(bool(torch.isfinite(got).all()), f"K5 {name}: non-finite")
    err = (got - want).abs()
    ok = bool((err <= K5_ATOL + K5_RTOL * want.abs()).all())
    check(ok, f"K5 {name}: kernel disagrees with the plain version "
          f"(max abs err {float(err.max())})")
    return float(err.max())


def phase_k5():
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    for name, c in k5_cases(gen).items():
        args = (c["q"], c["kbuf"], c["vbuf"], c["tables"], c["positions"])
        kw = dict(kv_heads=c["kv"], head_dim=c["d"])
        got = pa.paged_attend_cuda(*args, **kw)
        want = pa.paged_attend_reference(*args, **kw)
        torch.cuda.synchronize()
        max_err = k5_check(name, got, want)
        log(f"[k5] {name} shape=q{tuple(c['q'].shape)} "
            f"pool{tuple(c['kbuf'].shape)} {c['q'].dtype} "
            f"max_abs_err={max_err} tol=atol {K5_ATOL} rtol {K5_RTOL} ok=True")
        results[name] = dict(case=c, args=args, kw=kw, max_err=max_err)
    # the merge sums each row's spans in a fixed order: equal bits twice
    r = results["decode_b8_h32"]
    first = pa.paged_attend_cuda(*r["args"], **r["kw"])
    again = pa.paged_attend_cuda(*r["args"], **r["kw"])
    check(torch.equal(first, again), "K5 decode_b8_h32: two calls differ")
    log("[k5] decode_b8_h32 bitwise repeatable=True")
    return results


def time_k5(results, keep=False):
    from paddle_tpu_torch.ops.hopper.paged_attention import (
        paged_attend_cuda, paged_attend_reference)

    for name, r in results.items():
        args, kw = r["args"], r["kw"]
        # K5 and SDPA take less card time than their host enqueue: each is
        # timed from CUDA-graph replays, the host's cost apart (k5_host_us)
        r["ms"] = time_ms_graph(lambda: paged_attend_cuda(*args, **kw))
        r["plain_ms"] = time_ms(lambda: paged_attend_reference(*args, **kw),
                                iters=5, warmup=1)
        r["library_ms"] = time_ms_graph(k5_library_fn(r["case"]))
        r["bound_ms"], r["bound_by"] = k5_bound(r["case"])
        log(f"[time] k5 {name} ms={r['ms']} plain_ms={r['plain_ms']} "
            f"library_ms={r['library_ms']} bound_ms={r['bound_ms']} "
            f"({r['bound_by']}) bound_share={r['bound_ms'] / r['ms']}")
        if not keep:
            del r["case"], r["args"]     # the pools: ~0.5 GB per case
    torch.cuda.empty_cache()


def k5_entry(launches, results):
    """The kernels line's K5 entry: decode_b8_h32 with every other case
    under ``other_shapes``."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    return dict(
        kernel_entry("paged_attention", "cuda",
                     "paddle_tpu_torch/csrc/paged_attention.cu",
                     "paddle_tpu/ops/pallas/paged_attention.py:256",
                     launches, results, "decode_b8_h32"),
        other_shapes={n: dict({k: r[k] for k in keys},
                              max_abs_err=r["max_err"])
                      for n, r in results.items() if n != "decode_b8_h32"})


def k5_by_kernel(kernels, n):
    """K5's device ms per call (``n`` calls) by kernel and template, from
    :func:`device_events`' kernel dict."""
    parts = {}
    for key, us in kernels.items():
        found = re.search(r"paged_attend_kernel\w*(<[^>]*>)?", key)
        if found:
            parts[found.group(0)] = parts.get(found.group(0), 0.0) + us / 1e3 / n
    return parts


def k5_parts(results, calls=10):
    """Device ms per call of K5's split and merge kernels at each case,
    from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.ops.hopper.paged_attention import paged_attend_cuda

    for name, r in results.items():
        paged_attend_cuda(*r["args"], **r["kw"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                paged_attend_cuda(*r["args"], **r["kw"])
            torch.cuda.synchronize()
        kernels, _ = device_events(prof)
        log(f"[k5-parts] {name} device_ms_per_call="
            f"{json.dumps(k5_by_kernel(kernels, calls))}")


def k5_host_us(results, calls=100, rounds=5):
    """Host microseconds per wrapper call (enqueue only: the calls run
    back to back without a synchronise, well inside the launch queue),
    ``rounds`` rounds per case taken in turns; prints each round."""
    from paddle_tpu_torch.ops.hopper.paged_attention import paged_attend_cuda

    names = ("decode_b8_h32", "decode_serving_depths", "prefill_s128_pos256")
    rounds_us = {n: [] for n in names}
    for _ in range(rounds):
        for name in names:
            r = results[name]
            for _ in range(5):
                paged_attend_cuda(*r["args"], **r["kw"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                paged_attend_cuda(*r["args"], **r["kw"])
            rounds_us[name].append((time.perf_counter() - t0) * 1e6 / calls)
            torch.cuda.synchronize()
    for name, us in rounds_us.items():
        log(f"[k5-host] {name} host_us_per_call min={min(us)} "
            f"median={sorted(us)[len(us) // 2]} rounds={us}")


def k5_host_parts(results, calls=100):
    """Host microseconds of each part of a wrapper call at decode_b8_h32
    (the least of 5 rounds of ``calls`` back-to-back calls, enqueue
    only): the checks, one allocation, the stream lookup, and the
    library call (both kernels' launches)."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    r = results["decode_b8_h32"]
    q, kbuf, vbuf, tables, pos = r["args"]
    kv, d = r["kw"]["kv_heads"], r["kw"]["head_dim"]
    b, s, h, _ = q.shape
    n = b * s * h * d
    buf = torch.empty(n * 40, device=q.device, dtype=torch.float32)
    lib = pa._library()

    def launch():
        lib.paged_attend_launch(
            q.data_ptr(), kbuf.data_ptr(), vbuf.data_ptr(), tables.data_ptr(),
            pos.data_ptr(), buf.data_ptr(), buf.data_ptr() + n * 4, b, s, h,
            kv, d, kbuf.shape[1], tables.shape[1], 1, d ** -0.5, 0, 0,
            torch._C._cuda_getCurrentRawStream(q.device.index))

    parts = {
        "check": lambda: pa._check(q, kbuf, vbuf, tables, pos, kv, d),
        "empty": lambda: torch.empty(n * 40, device=q.device,
                                     dtype=torch.float32),
        "stream": lambda: torch._C._cuda_getCurrentRawStream(q.device.index),
        "library_call": launch,
    }
    us = {}
    for name, fn in parts.items():
        for _ in range(5):          # rounds of enqueue only; the least
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t = (time.perf_counter() - t0) * 1e6 / calls
            torch.cuda.synchronize()
            us[name] = min(us.get(name, t), t)
    log(f"[k5-host] parts_us_per_call={json.dumps(us)}")


def k5_sweep(results, widths=(0, 64, 128, 256, 512)):
    """Each case through both bodies (the tensor cores for bf16/f16
    only) at each span width (0: the kernel's own choice): checked
    against the plain version, timed. The wrapper's body is marked."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    for name, r in results.items():
        q = r["args"][0]
        kv = r["kw"]["kv_heads"]
        want = pa.paged_attend_reference(*r["args"], **r["kw"])
        chosen = pa._tensor_cores(q.dtype, q.shape[1], q.shape[2] // kv)
        bodies = (False,) if q.dtype == torch.float32 else (False, True)
        for tc in bodies:
            for w in widths:
                call = functools.partial(
                    pa._launch, *r["args"], kv, r["kw"]["head_dim"],
                    tensor_cores=tc, split_cols=w)
                err = k5_check(f"{name} sweep", call(), want)
                log(f"[k5-sweep] {name} body={'tc' if tc else 'cc'} "
                    f"split_cols={w or 'chosen'} ms={time_ms_graph(call)} "
                    f"max_abs_err={err}"
                    f"{' (the wrapper body)' if tc == chosen else ''}")


# -- phase 3 and 5: K6 --------------------------------------------------------

def host_us(fn, calls=100, rounds=5):
    """Host microseconds per call of ``fn`` (enqueue only: the calls run
    back to back without a synchronise, well inside the launch queue):
    (least, median, every round) of ``rounds`` rounds of ``calls``."""
    us = []
    for _ in range(rounds):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        us.append((time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return min(us), sorted(us)[len(us) // 2], us


def k6_inputs(gen, rows, h, dtype):
    x = torch.randn(rows, h, device="cuda", generator=gen).to(dtype)
    w = (1 + 0.1 * torch.randn(h, device="cuda", generator=gen)).to(dtype)
    return x, w


def k6_check(name, x, w):
    """K6 against its plain version on (x, w), called twice for equal
    bits. Returns (max_abs_err of out, a failure message or None)."""
    from paddle_tpu_torch.ops.hopper.rms_norm import (rms_norm_cuda,
                                                      rms_norm_reference)

    out, rstd = rms_norm_cuda(x, w, 1e-5)
    out2, rstd2 = rms_norm_cuda(x, w, 1e-5)
    want, want_r = rms_norm_reference(x, w, 1e-5)
    torch.cuda.synchronize()
    tol = K6_TOL[x.dtype]
    err = (out.float() - want.float()).abs()
    max_err = float(err.max())
    ok = bool(torch.isfinite(out).all()) and bool(
        (err <= tol + tol * want.float().abs()).all())
    rstd_ok = bool(((rstd - want_r).abs() <= K6_RSTD_RTOL
                    * want_r.abs()).all())
    same = torch.equal(out, out2) and torch.equal(rstd, rstd2)
    log(f"[k6] {name} max_abs_err={max_err} tol=atol {tol} rtol {tol} "
        f"ok={ok} rstd_rtol {K6_RSTD_RTOL} rstd_ok={rstd_ok} "
        f"bitwise_equal={same}")
    if ok and rstd_ok and same:
        return max_err, None
    return max_err, (f"K6 {name}: kernel disagrees with the plain version"
                     f" (out ok={ok}, rstd ok={rstd_ok}, equal bits={same})")


def k6_cases():
    """(name, rows, h, dtype, main): the main path's three shapes (timed)
    and K6_EXTRA_CASES."""
    cases = [(f"rows{rows}_h4096", rows, 4096, torch.bfloat16, True)
             for rows in (8, 128, K6_TRAIN_ROWS)]
    cases += [(f"rows{rows}_h{h}_{str(dt).split('.')[-1]}", rows, h, dt,
               False) for rows, h, dt in K6_EXTRA_CASES]
    return cases


def phase_k6(failures=None):
    """K6 at every case of :func:`k6_cases`. A failure ends the run, or,
    given a ``failures`` list, is added to it."""
    gen = torch.Generator(device="cuda").manual_seed(99)
    results = {}
    for name, rows, h, dtype, main in k6_cases():
        x, w = k6_inputs(gen, rows, h, dtype)
        max_err, failure = k6_check(name, x, w)
        if failures is None:
            check(failure is None, failure)
        elif failure:
            failures.append(failure)
        results[name] = dict(x=x, w=w, max_err=max_err, main=main)
    return results


def time_k6(results):
    """K6 at the main shapes beside F.rms_norm, the plain version and the
    bound: back to back (``ms``) and by CUDA-graph replay (``graph_ms``,
    K6 and the library call alike), which leaves out the host's launch
    cost, and the wrapper's host microseconds per call."""
    from paddle_tpu_torch.ops.hopper.rms_norm import (rms_norm_cuda,
                                                      rms_norm_reference)

    lib = getattr(torch.nn.functional, "rms_norm", None)
    for name, r in results.items():
        if not r["main"]:
            continue
        x, w = r["x"], r["w"]
        rows, h = x.shape
        el = x.element_size()
        nbytes = 2 * rows * h * el + h * el + rows * 4
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = 4 * rows * h / PEAK_OPS_S[torch.float32] * 1e3
        r["bound_ms"], r["bound_by"] = ((t_bytes, "bytes") if t_bytes >= t_ops
                                        else (t_ops, "operations"))
        r["ms"] = time_ms(lambda: rms_norm_cuda(x, w, 1e-5), iters=100)
        r["graph_ms"] = time_ms_graph(lambda: rms_norm_cuda(x, w, 1e-5),
                                      iters=100)
        r["plain_ms"] = time_ms(lambda: rms_norm_reference(x, w, 1e-5),
                                iters=100)
        r["library_ms"] = (None if lib is None else time_ms(
            lambda: lib(x, (h,), w, 1e-5), iters=100))
        r["library_graph_ms"] = (None if lib is None else time_ms_graph(
            lambda: lib(x, (h,), w, 1e-5), iters=100))
        us_min, us_med, us = host_us(lambda: rms_norm_cuda(x, w, 1e-5))
        r["host_us"] = us_min
        log(f"[time] k6 {name} ms={r['ms']} graph_ms={r['graph_ms']} "
            f"plain_ms={r['plain_ms']} library_ms={r['library_ms']} "
            f"library_graph_ms={r['library_graph_ms']} bound_ms="
            f"{r['bound_ms']} ({r['bound_by']}) bound_share="
            f"{r['bound_ms'] / r['graph_ms']}")
        log(f"[k6-host] {name} host_us_per_call min={us_min} "
            f"median={us_med} rounds={us}")


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


def flash_row_err(got, want, floor=0.0):
    """The worst row of out, dq, dk or dv: over every (batch, row, head),
    the largest |got - want| over that row's largest |want|. A row of out
    is a weighted mean of V rows, so rows that see many keys are far
    smaller than the first causal rows; dq of the first causal rows and
    dk/dv of the last keys (which few queries see) are far smaller than
    the rest. A limit scaled to the whole tensor's largest value would
    pass a fault confined to such rows. A row's scale is at least
    ``floor`` times the tensor's largest |want| (FLASH_ROW_FLOOR for the
    gradients), for rows that are zero in exact arithmetic."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(-1)
    top = w.abs().amax(-1).clamp(min=floor * float(w.abs().max()))
    return float(torch.where(err == 0, 0.0, err / top).max())


def phase_flash():
    """Each case: the forward kernel against the plain forward (out,
    lse), then the dq and dkv kernels against the plain FA2 backward
    (dq, dk, dv), both backward versions fed the plain forward's out and
    lse so that each kernel is judged on its own; bf16 outputs also row
    by row (flash_row_err), and a second bf16 backward call must give
    the same bits (no atomics)."""
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
        again = (fa.flash_attention_bwd_cuda(q, k, v, want_out, want_lse,
                                             do, causal, scale)
                 if dt == torch.bfloat16 else grads)
        want_grads = fa.flash_attention_bwd_reference(
            q, k, v, want_out, want_lse, do, causal, scale)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(grads, again))
        log(f"[flash] {name} dq/dk/dv of two calls bitwise_equal={same}")
        check(same, f"flash {name}: two backward calls differ")
        errs = {}
        for key, got, want in zip(("out", "dq", "dk", "dv"),
                                  (out, *grads), (want_out, *want_grads)):
            check(bool(torch.isfinite(got).all()), f"flash {name}: {key} "
                  f"not finite")
            err = float((got.float() - want.float()).abs().max())
            tol = (FLASH_F32_ATOL if dt == torch.float32 else
                   FLASH_BF16_REL * float(want.float().abs().max()))
            errs[key] = err
            row_tol = FLASH_BF16_REL if key == "out" else FLASH_GRAD_ROW_REL
            row_err = (flash_row_err(got, want, FLASH_ROW_FLOOR
                                     if key != "out" else 0.0)
                       if dt != torch.float32 else 0.0)
            rows = (f" worst_row_rel_err={row_err} row_tol={row_tol}"
                    f" (of each row's largest value)" if row_err else "")
            log(f"[flash] {name} {key} max_abs_err={err} tol={tol}{rows}")
            check(err <= tol, f"flash {name}: {key} disagrees with the "
                  f"plain version")
            check(row_err <= row_tol, f"flash {name}: a row of {key} "
                  f"disagrees with the plain version")
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
        del q, k, v, do, out, lse, want_out, want_lse, grads, again
        del want_grads
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
    library times of dq and dkv are those of the whole backward, which is
    also timed as the port runs it (delta, dq, dkv), with delta's
    share."""
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
    whole, delta_ms = time_flash_bwd_whole(m)
    log(f"[time] flash backward pair dq+dkv ms="
        f"{timing['dq']['ms'] + timing['dkv']['ms']} whole_backward_ms="
        f"{whole} (delta, dq, dkv) delta_ms={delta_ms} delta_share="
        f"{delta_ms / whole} sdpa_backward_ms={lib_bwd} (dq, dk, dv in one "
        f"call)")
    del results["main"], qt, kt, vt, lib_out
    torch.cuda.empty_cache()
    return timing


def time_flash_bwd_whole(m):
    """ms of ``flash_attention_bwd_cuda`` (delta = rowsum(dO O) in plain
    torch, then the dq and dkv kernels) and of its delta alone."""
    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    q, k, v, do, out = m["q"], m["k"], m["v"], m["do"], m["out"]
    whole = time_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, out, m["lse"], do, m["causal"], m["scale"]))
    delta_ms = time_ms(lambda: (do.float() * out.float()).sum(-1).transpose(
        1, 2).contiguous())
    return whole, delta_ms


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


# K5's family: its split kernels (paged_attend_kernel_cc, _tc) and merge
KERNEL_FAMILIES = (("k5_paged_attention", ("paged_attend_kernel",)),
                   ("k6_rms_norm", ("rms_norm_fwd",)),
                   ("matmul", ("nvjet", "gemm", "cutlass", "xmma")))


def device_events(prof):
    """Device microseconds by name in a torch.profiler window: (kernels
    and copies, the port's ``TrainStep.*`` ranges). Device-side entries
    carry no host time; the aten ops that launched them do and are
    skipped, so nothing is counted twice. A ``record_function`` range
    also leaves a device-side entry, whose time is the range's span on
    the device: it goes to the second dict, never into a family."""
    kernels, ranges = {}, {}
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us <= 0 or evt.self_cpu_time_total > 0:
            continue
        into = ranges if evt.key.startswith("TrainStep.") else kernels
        into[evt.key] = into.get(evt.key, 0.0) + dev_us
    return kernels, ranges


def device_ms_by_family(prof, families, n, others=None, ranges=None):
    """Device milliseconds per unit (``n`` units in the window) by kernel
    family, from a torch.profiler window. ``others``, a dict, collects
    the kernels of the "other" family by name; ``ranges``, a dict, the
    device span of each ``TrainStep.*`` range."""
    device_ms = dict.fromkeys([f for f, _ in families] + ["other"], 0.0)
    kernels, spans = device_events(prof)
    for key, dev_us in kernels.items():
        fam = next((f for f, keys in families
                    if any(k in key for k in keys)), "other")
        device_ms[fam] += dev_us / 1e3 / n
        if fam == "other" and others is not None:
            others[key] = others.get(key, 0.0) + dev_us / 1e3 / n
    if ranges is not None:
        ranges.update((k, v / 1e3 / n) for k, v in spans.items())
    return device_ms


def profile_window(engine, vocab, steps=4):
    """Where a serving step's time goes, on a fresh 8-request batch:
    ``steps`` engine steps timed on the host clock without the profiler,
    then ``steps`` more under torch.profiler (whose own host cost makes
    its wall time useless). Prints device time per dispatch by kernel
    family and the device's idle share: 1 - device time per dispatch
    (profiled steps) / wall time per dispatch (unprofiled steps). Then
    the same by dispatch kind (:func:`profile_dispatch_kinds`) once the
    window's requests have finished."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(11)
    for n in rng.integers(128, 513, 8):
        engine.add_request(rng.integers(0, vocab, n).tolist(),
                           max_new_tokens=32)
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    captured = {}
    dispatch = engine._dispatch

    def capturing_dispatch(ids, positions, lengths, block_tables):
        # the fullest decode batch and the latest full prefill chunk
        if ids.shape[0] == engine.max_slots:
            kind, key = "decode", (int((lengths > 0).sum()),
                                   int(positions.sum()))
        else:
            kind, key = "prefill", (int(lengths[0]), int(positions[0]))
        if key > captured.get(kind, ((-1, -1),))[0]:
            captured[kind] = (key, [a.copy() for a in (ids, positions,
                                                       lengths, block_tables)])
        return dispatch(ids, positions, lengths, block_tables)

    engine._dispatch = capturing_dispatch
    d0, t0 = engine.dispatches, time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / (engine.dispatches - d0)
    engine._dispatch = dispatch
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
    engine._dispatch = capturing_dispatch
    engine.run()
    engine._dispatch = dispatch
    profile_dispatch_kinds(engine, captured)


def profile_dispatch_kinds(engine, captured, reps=3):
    """Device ms of one prefill dispatch and of one decode-only dispatch,
    each replayed ``reps`` times under torch.profiler from the arguments
    captured in the window and the run after it (the latest full prefill
    chunk, the fullest decode batch): by kernel family, and K5's split
    and merge kernels apart. The requests have finished, so what a
    replay writes into their freed blocks reaches nothing live."""
    from torch.profiler import ProfilerActivity, profile

    for kind in ("prefill", "decode"):
        check(kind in captured, f"no {kind} dispatch in the window")
        (live, _), args = captured[kind]
        engine._dispatch(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                engine._dispatch(*args)
            torch.cuda.synchronize()
        device_ms = device_ms_by_family(prof, KERNEL_FAMILIES, reps)
        k5 = k5_by_kernel(device_events(prof)[0], reps)
        log(f"[profile] {kind} dispatch (ids {tuple(args[0].shape)}, "
            f"{live} {'live rows' if kind == 'decode' else 'tokens'}, "
            f"positions {args[1].tolist()}): device_busy_ms="
            f"{sum(device_ms.values())} by_family={json.dumps(device_ms)} "
            f"k5_by_kernel={json.dumps(k5)}")


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
    others, ranges = {}, {}
    device_ms = device_ms_by_family(prof, TRAIN_FAMILIES, steps, others,
                                    ranges)
    busy_ms = sum(device_ms.values())
    log(f"[train-profile] per step: wall_ms={wall_ms} (unprofiled) "
        f"device_busy_ms={busy_ms} device_idle_share={1 - busy_ms / wall_ms}"
        f" ({steps} profiled steps)")
    log(f"[train-profile] device_ms_per_step_by_family="
        f"{json.dumps(device_ms)}")
    log(f"[train-profile] device span per step of the TrainStep ranges: "
        f"{json.dumps(ranges)}")
    top = sorted(others.items(), key=lambda kv: -kv[1])[:10]
    log(f"[train-profile] largest of other, ms per step: "
        f"{json.dumps([(k[:90], v) for k, v in top])}")


# -- phases 10-12: ResNet-50 -------------------------------------------------

RESNET_BATCH, RESNET_SIZE = 256, 224
# ResNet-50 forward at 224^2: 4.089 GFLOP per image (bench.py), x3 for the
# training step
RESNET_FLOP_PER_IMAGE = 3 * 4.089e9
# launches per training step with both flags on: 16 fused blocks (two
# 1x1 units each), 11 of them with a stride-1 3x3 that K8 takes, and the
# four downsample BatchNorms that K9 takes
RESNET_LAUNCHES = dict(k7_fwd=32, k7_bwd=32, k8_fwd=11, k8_bwd=11, k9=4)

# kernel vs plain, bf16 at ResNet-50 shapes. Both sides accumulate in f32
# over the same bf16 operands: bf16 outputs (y, dx) to 2 bf16 ulps of the
# largest element (one rounding each side, and dyc may round the other
# way where the two f32 sums straddle a bf16 boundary). The f32 sums
# differ only in summation order over up to 802,816 rows; each is held to
# about five times the largest error read on the H100 at these shapes,
# relative to the largest element: s1, s2, da, db, mean and E[x^2] read
# 2e-7 to 4e-6 (limit 2e-5); dw reads 2e-6 to 4.3e-5, the most in K8's
# layer-1 case, whose nine taps each sum 802,816 rows (limit 2e-4). A
# kernel that drops one partial sum of its deterministic reduction is
# off by more: one of K9's 523 row partials by ~2e-3, one of K7's
# forward's per-CTA partials of s2 (at most one per SM) by about its share
# of the rows, ~1/132.
RU_BF16_REL = 2.0 ** -7
RU_SUM_REL = dict(s1=2e-5, s2=2e-5, da=2e-5, db=2e-5, mean=2e-5, m2=2e-5,
                  dw=2e-4)
# one bottleneck at full width, bf16. Its bf16 gradients carry rounding
# noise of 4-9% (relative L2) against the same computation in f32, in
# both compositions (a relu at a bf16 tie, BatchNorm's centring), and
# two bf16 runs that round one value differently diverge by as much. So
# each bf16 run is held against one f32 reference (the fused composition
# in f32 on the CPU, which in f32 equals the default one): the card's
# relative L2 error (kernels) at most 1.25 x the CPU's (plain versions,
# the same rounding points) + 1e-3, and the fused composition's at most
# 1.5 x the default composition's + 1e-3, for every gradient and running
# statistic; the output, card vs CPU, to 2^-5 of its largest element
BLOCK_OUT_REL = 2.0 ** -5
BLOCK_VS_PLAIN = 1.25
FUSED_VS_DEFAULT = 1.5
BLOCK_SLACK = 1e-3

# (name, kind, shape): the main path's shapes at batch 256, 224^2
RU_CASES = [
    ("conv1x1_prologue_layer1_unit_b_802816x64x256", "k7",
     dict(rows=802816, cin=64, cout=256, pro=True)),
    ("conv1x1_layer4_unit_a_12544x2048x512", "k7",
     dict(rows=12544, cin=2048, cout=512, pro=False)),
    ("conv1x1_prologue_layer2_unit_b_200704x128x512", "k7",
     dict(rows=200704, cin=128, cout=512, pro=True)),
    ("conv1x1_layer3_unit_a_50176x1024x256", "k7",
     dict(rows=50176, cin=1024, cout=256, pro=False)),
    ("conv3x3_layer1_256x56x56x64", "k8", dict(n=256, h=56, w=56, c=64)),
    ("conv3x3_layer3_256x14x14x256", "k8", dict(n=256, h=14, w=14, c=256)),
    ("conv3x3_layer2_256x28x28x128", "k8", dict(n=256, h=28, w=28, c=128)),
]
# K9 (name, rows, c, dtype, main): the main path's four shapes (the
# downsample BatchNorms of layers 1-4, timed), then ragged rows (a last
# row range of 8 rows, under one 32-row group), 8 rows, 128-channel
# strips and f16
K9_CASES = [
    ("rows802816_c256", 802816, 256, torch.bfloat16, True),
    ("rows200704_c512", 200704, 512, torch.bfloat16, True),
    ("rows50176_c1024", 50176, 1024, torch.bfloat16, True),
    ("rows12544_c2048", 12544, 2048, torch.bfloat16, True),
    ("rows1000_c256", 1000, 256, torch.bfloat16, False),
    ("rows8_c256", 8, 256, torch.bfloat16, False),
    ("rows12544_c128", 12544, 128, torch.bfloat16, False),
    ("rows50176_c1024_f16", 50176, 1024, torch.float16, False),
]


def _bound(nbytes, ops_by_type):
    """(least ms, "bytes" or "operations"): the larger of the bytes time
    (over the HBM rate) and the operations time. The tensor cores and
    the CUDA cores of an SM run at the same time, so the operations time
    is that of the slowest type: each type's operations over its peak,
    the largest of these."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = max(n / PEAK_OPS_S[dt] for dt, n in ops_by_type.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ru_inputs(gen, kind, shape):
    """Seeded bf16 activations and weights, f32 prologue and statistic
    cotangents, at a case's shape."""
    dev = torch.device("cuda")

    def rnd(*sh, scale=1.0):
        return torch.randn(*sh, device=dev, generator=gen) * scale

    if kind == "k7":
        rows, cin, cout = shape["rows"], shape["cin"], shape["cout"]
        x = rnd(rows, cin).bfloat16()
        w = rnd(cin, cout, scale=cin ** -0.5).bfloat16()
        xs, ys = (rows, cin), (rows, cout)
        pro = shape["pro"]
    else:
        n, h, wd, c = shape["n"], shape["h"], shape["w"], shape["c"]
        cin = cout = c
        x = rnd(n, h, wd, c).bfloat16()
        w = rnd(9, c, c, scale=(9 * c) ** -0.5).bfloat16()
        xs, ys = (n, h, wd, c), (n, h, wd, c)
        pro = True
    a = (torch.rand(cin, device=dev, generator=gen) + 0.5) if pro else None
    b = rnd(cin, scale=0.5) if pro else None
    dy = rnd(*ys).bfloat16()
    gs1 = rnd(cout, scale=1e-3)
    gs2 = rnd(cout, scale=1e-5)
    return dict(x=x, w=w, a=a, b=b, dy=dy, gs1=gs1, gs2=gs2, xs=xs, ys=ys)


def _ru_fns(kind):
    from paddle_tpu_torch.ops.hopper import resnet_unit as ru

    if kind == "k7":
        return (ru.conv1x1_bn_fwd_cuda, ru.conv1x1_bn_fwd_reference,
                ru.conv1x1_bn_bwd_cuda, ru.conv1x1_bn_bwd_reference)
    return (ru.conv3x3_bn_fwd_cuda, ru.conv3x3_bn_fwd_reference,
            ru.conv3x3_bn_bwd_cuda, ru.conv3x3_bn_bwd_reference)


def _bwd_args(kind, c, y):
    head = (c["x"], c["w"], c["a"], c["b"])
    tail = (c["dy"], c["gs1"], c["gs2"])
    return head + tail if kind == "k7" else head + (y,) + tail


def _rel_err(got, want):
    err = float((got.float() - want.float()).abs().max())
    return err, err / max(float(want.float().abs().max()), 1e-30)


def phase_resnet_kernels(cases=RU_CASES, k9_cases=K9_CASES, backward=True):
    """K7 and K8 (forward and, with ``backward``, backward) and K9 against
    their plain versions at ResNet-50 shapes; K8's forward, K7's
    backward and K9 twice, for equal bits. The backward versions both take
    the plain forward's y."""
    gen = torch.Generator(device="cuda").manual_seed(2024)
    results = {}
    for name, kind, shape in cases:
        c = _ru_inputs(gen, kind, shape)
        fwd_k, fwd_p, bwd_k, bwd_p = _ru_fns(kind)
        got = fwd_k(c["x"], c["w"], c["a"], c["b"])
        want = fwd_p(c["x"], c["w"], c["a"], c["b"])
        if kind == "k8":
            check(all(torch.equal(g, r) for g, r in zip(
                got, fwd_k(c["x"], c["w"], c["a"], c["b"]))),
                f"{name}: two forward calls differ (fixed-order sums)")
        gotb = bwd_k(*_bwd_args(kind, c, want[0])) if backward else ()
        if backward and kind == "k7":
            check(all(g is None or torch.equal(g, r) for g, r in zip(
                gotb, bwd_k(*_bwd_args(kind, c, want[0])))),
                f"{name}: two backward calls differ (fixed-order sums)")
        wantb = bwd_p(*_bwd_args(kind, c, want[0])) if backward else ()
        torch.cuda.synchronize()
        errs = {}
        for key, g, wnt in zip(("y", "s1", "s2", "dx", "dw", "da", "db"),
                               (*got, *gotb), (*want, *wantb)):
            if wnt is None:
                check(g is None, f"{name}: {key} should be None")
                continue
            check(bool(torch.isfinite(g).all()), f"{name}: {key} not finite")
            err, rel = _rel_err(g, wnt)
            tol = (RU_BF16_REL if wnt.dtype == torch.bfloat16
                   else RU_SUM_REL[key])
            errs[key] = err
            log(f"[resnet-kernels] {name} {key} max_abs_err={err} "
                f"rel_to_max={rel} tol={tol}")
            check(rel <= tol, f"{name}: {key} disagrees with the plain "
                  f"version")
        results[name] = dict(kind=kind, shape=shape, case=c, y=want[0],
                             errs=errs)
        del got, gotb, wantb
    for name, rows, ch, dtype, main in k9_cases:
        x = (torch.randn(rows, ch, device="cuda", generator=gen) * 2
             + 1.5).to(dtype)
        errs, failure = k9_check(name, x)
        check(failure is None, failure)
        results[f"k9_{name}"] = dict(kind="k9", x=x, errs=errs, main=main)
    return results


def k9_check(name, x):
    """K9 against its plain version on x, called twice for equal bits.
    Returns ({"mean": max_abs_err, "m2": ...}, a failure message or
    None)."""
    from paddle_tpu_torch.ops.hopper import bn_stats as bn

    got, again = bn.bn_stats_cuda(x), bn.bn_stats_cuda(x)
    want = bn.bn_stats_reference(x)
    torch.cuda.synchronize()
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    errs, bad = {}, []
    for key, g, wnt in zip(("mean", "m2"), got, want):
        err, rel = _rel_err(g, wnt)
        errs[key] = err
        log(f"[resnet-kernels] k9 {name} {key} max_abs_err={err} "
            f"rel_to_max={rel} tol={RU_SUM_REL[key]}")
        if not (bool(torch.isfinite(g).all()) and rel <= RU_SUM_REL[key]):
            bad.append(key)
    log(f"[resnet-kernels] k9 {name} bitwise_equal={same}")
    if not same:
        bad.append("two calls differ")
    if not bad:
        return errs, None
    return errs, f"K9 {name}: {', '.join(bad)} disagree with the plain version"


def _ru_bounds(kind, c):
    """Bounds of (forward, backward) of a K7/K8 case: each input read
    once and each output written once; the products on the tensor cores
    (forward 2 K, backward 6 K for K7, which recomputes y, 4 K for K8,
    per output element of y), the prologue and epilogue in f32."""
    rows = c["x"].numel() // c["xs"][-1]
    cin, cout = c["xs"][-1], c["ys"][-1]
    taps = 1 if kind == "k7" else 9
    pro = 2 * cin * 4 if c["a"] is not None else 0
    w = c["w"].numel() * 2
    act_in, act_out = rows * cin * 2, rows * cout * 2
    mac = rows * cin * cout * taps
    f32_fwd = 3 * rows * cin * (c["a"] is not None) + 3 * rows * cout
    fwd = _bound(act_in + w + pro + act_out + 2 * cout * 4,
                 {torch.bfloat16: 2 * mac, torch.float32: f32_fwd})
    bwd_in = act_in + w + pro + act_out + 2 * cout * 4
    if kind == "k8":
        bwd_in += act_out                     # the saved y
    bwd_out = act_in + c["w"].numel() * 4 + pro
    f32_bwd = 4 * rows * cout + 6 * rows * cin
    bwd = _bound(bwd_in + bwd_out,
                 {torch.bfloat16: (6 if kind == "k7" else 4) * mac,
                  torch.float32: f32_bwd})
    return fwd, bwd


def _ru_library(kind, c, y):
    """One PyTorch call per direction computing the same convolution:
    the forward as torch.matmul (1x1) or F.conv2d on channels-last
    views (3x3); the backward as aten.convolution_backward (dx and dw of
    the convolution, without the BatchNorm terms)."""
    x, w, dy = c["x"], c["w"], c["dy"]
    if kind == "k7":
        rows, cin = x.shape
        cout = w.shape[1]
        n = RESNET_BATCH
        hw = int(round((rows // n) ** 0.5))
        x4 = x.reshape(n, hw, hw, cin).permute(0, 3, 1, 2)
        dy4 = dy.reshape(n, hw, hw, cout).permute(0, 3, 1, 2)
        w4 = w.t().reshape(cout, cin, 1, 1).contiguous(
            memory_format=torch.channels_last)
        fwd = lambda: torch.matmul(x, w)                     # noqa: E731
        pad = 0
    else:
        x4 = x.permute(0, 3, 1, 2)
        dy4 = dy.permute(0, 3, 1, 2)
        w4 = c["w"].reshape(3, 3, *w.shape[1:]).permute(3, 2, 0, 1
                                                        ).contiguous(
            memory_format=torch.channels_last)
        fwd = lambda: torch.nn.functional.conv2d(x4, w4, padding=1)  # noqa
        pad = 1

    def bwd():
        return torch.ops.aten.convolution_backward(
            dy4, x4, w4, None, [1, 1], [pad, pad], [1, 1], False, [0, 0], 1,
            [True, True, False])
    return fwd, bwd


def ru_parts(fn, args, iters=5):
    """Device ms per launch of each part of one K7 or K8 wrapper (K7:
    forward, backward one pass or dyc, dx, dw, the reductions; K8
    forward: band kernel, reduction; K8 backward: dyc, dw, dx, the
    reductions), from a torch.profiler window over ``iters`` launches.
    A kernel of neither (another checkout's port) is booked under its
    own name."""
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn(*args)
        torch.cuda.synchronize()
    parts = {}
    for key, dev_us in device_events(prof)[0].items():
        part = resnet_part(key) or key[:60]
        parts[part] = parts.get(part, 0.0) + dev_us / 1e3 / iters
    return parts


def time_resnet_kernels(results, backward=True):
    timing = {}
    for name, r in results.items():
        if r["kind"] == "k9":
            if r["main"]:
                timing[name] = dict(k9=time_k9(r["x"]))
            continue
        kind, c, y = r["kind"], r["case"], r["y"]
        fwd_k, fwd_p, bwd_k, bwd_p = _ru_fns(kind)
        fargs = (c["x"], c["w"], c["a"], c["b"])
        bargs = _bwd_args(kind, c, y)
        lib_f, lib_b = _ru_library(kind, c, y)
        (bf, byf), (bb, byb) = _ru_bounds(kind, c)
        t = {"fwd": dict(ms=time_ms(lambda: fwd_k(*fargs)),
                         plain_ms=time_ms(lambda: fwd_p(*fargs), iters=3,
                                          warmup=1),
                         library_ms=time_ms(lib_f), bound_ms=bf,
                         bound_by=byf)}
        parts = [("fwd", fwd_k, fargs)]
        if backward:
            t["bwd"] = dict(ms=time_ms(lambda: bwd_k(*bargs)),
                            plain_ms=time_ms(lambda: bwd_p(*bargs), iters=3,
                                             warmup=1),
                            library_ms=time_ms(lib_b), bound_ms=bb,
                            bound_by=byb)
            parts.append(("bwd", bwd_k, bargs))
        for d, fn, args in parts:
            t[d]["parts"] = ru_parts(fn, args)
            log(f"[time] {kind} {d} {name} device ms per launch by part: "
                f"{json.dumps(t[d]['parts'])}")
        timing[name] = t
        for d, tt in t.items():
            log(f"[time] {kind} {d} {name} ms={tt['ms']} plain_ms="
                f"{tt['plain_ms']} library_ms={tt['library_ms']} "
                f"({'matmul/conv2d' if d == 'fwd' else 'convolution_backward'})"
                f" bound_ms={tt['bound_ms']} ({tt['bound_by']}) bound_share="
                f"{tt['bound_ms'] / tt['ms']}")
    results.clear()
    torch.cuda.empty_cache()
    return timing


def time_k9(x):
    """K9 on x beside torch.var_mean, the plain version and the bound:
    back to back (``ms``) and by CUDA-graph replay (``graph_ms``, K9 and
    the library call alike), and the wrapper's host microseconds per
    call."""
    from paddle_tpu_torch.ops.hopper import bn_stats as bn

    rows, ch = x.shape
    t = dict(ms=time_ms(lambda: bn.bn_stats_cuda(x)),
             graph_ms=time_ms_graph(lambda: bn.bn_stats_cuda(x)),
             plain_ms=time_ms(lambda: bn.bn_stats_reference(x), iters=5,
                              warmup=1),
             library_ms=time_ms(lambda: torch.var_mean(x, dim=0)),
             library_graph_ms=time_ms_graph(
                 lambda: torch.var_mean(x, dim=0)))
    t["bound_ms"], t["bound_by"] = _bound(
        rows * ch * x.element_size() + 2 * ch * 4,
        {torch.float32: 3 * rows * ch})
    us_min, us_med, us = host_us(lambda: bn.bn_stats_cuda(x))
    t["host_us"] = us_min
    log(f"[time] k9 rows{rows}_c{ch} ms={t['ms']} graph_ms={t['graph_ms']} "
        f"plain_ms={t['plain_ms']} library_ms={t['library_ms']} "
        f"library_graph_ms={t['library_graph_ms']} (torch.var_mean) "
        f"bound_ms={t['bound_ms']} ({t['bound_by']}) bound_share="
        f"{t['bound_ms'] / t['graph_ms']}")
    log(f"[k9-host] rows{rows}_c{ch} host_us_per_call min={us_min} "
        f"median={us_med} rounds={us}")
    return t


def _block_run(blk, x, cot, fused_direct=False):
    """Output, gradients (input and parameters) and running statistics
    after one training forward/backward of ``blk``; ``fused_direct``
    calls the fused composition whatever the dtype (the f32
    reference)."""
    x = x.clone().requires_grad_()
    out = blk._forward_fused(x) if fused_direct else blk(x)
    out.backward(cot)
    tensors = {"grad x": x.grad}
    tensors.update((f"grad {n}", p.grad) for n, p in blk.named_parameters())
    tensors.update((f"buffer {n}", b) for n, b in blk.named_buffers())
    return out.detach(), {k: v.detach().float().cpu().clone()
                          for k, v in tensors.items()}


def _l2_rel(got, want):
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def phase_block_parity():
    """One layer-1 bottleneck at full width (256 -> 64 -> 256, 56^2,
    batch 8), bf16, flags on: the card (K7, K8) against the CPU (plain
    versions), and the fused composition against the default one on the
    card, each against the f32 reference (see BLOCK_VS_PLAIN)."""
    from paddle_tpu_torch import flags, load_reference_state
    from paddle_tpu_torch.vision.models import BottleneckBlock

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(17)

    def block(device, dtype="bfloat16", state=None):
        blk = BottleneckBlock(256, 64, data_format="NHWC", device=device,
                              dtype=dtype,
                              generator=gen if state is None else None)
        if state is not None:
            load_reference_state(blk, state)
        return blk.train()

    card = block("cuda")
    # copies: the card's buffers change in its run
    state = {n: t.detach().float().cpu().numpy().copy()
             for n, t in card.state_dict().items()}
    x = torch.randn(8, 56, 56, 256, device="cuda", generator=gen).bfloat16()
    cot = torch.randn(8, 56, 56, 256, device="cuda", generator=gen
                      ).bfloat16()
    _, ref = _block_run(block("cpu", "float32", state), x.cpu().float(),
                        cot.cpu().float(), fused_direct=True)
    flags.set_flags({"use_fused_resnet_unit": True,
                     "use_pallas_bn_stats": True})
    try:
        check(card._fused_ok(x) and card._uses_3x3_kernel(x),
              "the layer-1 block does not take K7 and K8")
        out_c, on_card = _block_run(card, x, cot)
        out_h, on_cpu = _block_run(block("cpu", state=state), x.cpu(),
                                   cot.cpu())
        flags.set_flags({"use_fused_resnet_unit": False,
                         "use_pallas_bn_stats": False})
        plain = block("cuda", state=state)
        check(not plain._fused_ok(x), "flags off still fuse")
        out_p, default = _block_run(plain, x, cot)
    finally:
        flags.set_flags({"use_fused_resnet_unit": False,
                         "use_pallas_bn_stats": False})
    check(all(bool(torch.isfinite(t).all()) for t in on_card.values()),
          "non-finite gradient or statistic on the card")
    _, rel = _rel_err(out_c.cpu(), out_h)
    log(f"[block] layer-1 bottleneck 256-64-256, 56^2, batch 8, bf16: "
        f"output card vs CPU {rel} of its largest element (tol "
        f"{BLOCK_OUT_REL}); fused vs default on the card "
        f"{_rel_err(out_c, out_p)[1]}")
    check(rel <= BLOCK_OUT_REL, "block output differs card vs CPU")
    rows = []
    for key, want in ref.items():
        e_card = _l2_rel(on_card[key], want)
        e_cpu = _l2_rel(on_cpu[key], want)
        e_def = _l2_rel(default[key], want)
        rows.append((key, e_card, e_cpu, e_def))
        check(e_card <= BLOCK_VS_PLAIN * e_cpu + BLOCK_SLACK,
              f"block {key}: card error {e_card} against f32 exceeds "
              f"{BLOCK_VS_PLAIN} x the CPU's {e_cpu}")
        check(e_card <= FUSED_VS_DEFAULT * e_def + BLOCK_SLACK,
              f"block {key}: fused error {e_card} against f32 exceeds "
              f"{FUSED_VS_DEFAULT} x the default composition's {e_def}")
    for key, e_card, e_cpu, e_def in rows:
        log(f"[block] {key}: relative L2 error against f32: card (fused, "
            f"kernels) {e_card} cpu (fused, plain) {e_cpu} card (default "
            f"composition) {e_def}")
    log(f"[block] all {len(rows)} gradients and statistics within "
        f"{BLOCK_VS_PLAIN} x the CPU's error and {FUSED_VS_DEFAULT} x the "
        f"default composition's (+{BLOCK_SLACK}); seconds="
        f"{time.perf_counter() - t0}")
    torch.cuda.empty_cache()


def _resnet_counts():
    from paddle_tpu_torch.ops.hopper import bn_stats as bn
    from paddle_tpu_torch.ops.hopper import resnet_unit as ru

    return dict(k7_fwd=ru.conv1x1_bn_fwd_cuda.launches,
                k7_bwd=ru.conv1x1_bn_bwd_cuda.launches,
                k8_fwd=ru.conv3x3_bn_fwd_cuda.launches,
                k8_bwd=ru.conv3x3_bn_bwd_cuda.launches,
                k9=bn.bn_stats_cuda.launches)


def _reset_resnet_counts():
    from paddle_tpu_torch.ops.hopper import bn_stats as bn
    from paddle_tpu_torch.ops.hopper import resnet_unit as ru

    for fn in (ru.conv1x1_bn_fwd_cuda, ru.conv1x1_bn_bwd_cuda,
               ru.conv3x3_bn_fwd_cuda, ru.conv3x3_bn_bwd_cuda,
               bn.bn_stats_cuda):
        fn.launches = 0


# K8's kernels (csrc/conv3x3_bn.cu) by name, with their family and part;
# their names hold "conv", so they are matched before cuDNN's keywords
K8_PARTS = (("conv3_fwd_band_kernel", "k8", "forward (bands)"),
            ("conv3_dyc_kernel", "k8", "backward dyc (elementwise)"),
            ("conv3_dw_band_kernel", "k8", "backward dw (bands, 9 taps)"),
            ("conv3_dx_band_kernel", "k8", "backward dx (bands)"),
            ("conv3_reduce_kernel", "k7_k8_reduce", None))


# K7's kernels (csrc/resnet_unit.cu) by name, with their part; earlier
# checkouts' kernels (gemm_rows_kernel, the forward or with a dyc or dx
# epilogue; gemm_dw_kernel) are booked by their template arguments
K7_PARTS = (("k7_rows_kernel<2,", "forward"),
            ("k7_onepass_kernel<", "backward one pass (y, dyc, dx, dw)"),
            ("k7_rows_kernel<0,", "backward dyc"),
            ("k7_rows_kernel<1,", "backward dx"),
            ("k7_dw_kernel<", "backward dw (split-K partials)"),
            ("gemm_dw_kernel<", "backward dw (split-K partials)"))


def resnet_family(name):
    """Kernel family of a device kernel name in a ResNet step."""
    name = name.replace(", ", ",")
    for kernel, fam, _ in K8_PARTS:
        if kernel in name:
            return fam
    if "gemm_rows_kernel<" in name or any(k in name for k, _ in K7_PARTS):
        return "k7"
    if "col_reduce_kernel" in name or "bwd_reduce_kernel" in name:
        return "k7_k8_reduce"
    if "bn_stats_" in name:
        return "k9"
    low = name.lower()
    if any(k in low for k in ("conv", "cudnn", "xmma", "implicit", "dgrad",
                              "wgrad", "fprop")):
        return "cudnn_conv"
    if any(k in low for k in ("gemm", "nvjet", "cutlass")):
        return "matmul"
    return "other"


def resnet_part(name):
    """Which part of K7/K8 a kernel is: by name (K8_PARTS, K7_PARTS);
    ``gemm_rows_kernel`` is K7's forward (in earlier checkouts, with five
    template arguments, its fourth picks the forward, dyc or dx); None
    for other kernels."""
    fam = resnet_family(name)
    if fam not in ("k7", "k8", "k7_k8_reduce"):
        return None
    name = name.replace(", ", ",")
    part = next((what for kernel, _, what in K8_PARTS
                 if kernel in name and what), None)
    part = part or next((what for kernel, what in K7_PARTS
                         if kernel in name), None)
    if part is not None:
        what = part
    elif "gemm_rows_kernel<" in name:
        targs = name.split("gemm_rows_kernel<")[1].split(">")[0].split(",")
        what = ("forward", "backward dyc", "backward dx")[
            int(targs[3]) if len(targs) == 5 else 0]
    else:
        return "reductions (statistics, da/db, dw)"
    return f"{fam} {what}"


def profile_resnet_window(step, x, y, wall_ms, steps=2):
    """Device ms per step by family, the optimizer update's device ms
    (the ``TrainStep.update`` range) and the idle share against the
    unprofiled step time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(x, y)
        torch.cuda.synchronize()
    fams = dict.fromkeys(["k7", "k8", "k7_k8_reduce", "k9", "cudnn_conv",
                          "matmul", "other"], 0.0)
    others = {}
    kernels, spans = device_events(prof)
    for key, dev_us in kernels.items():
        fam = resnet_family(key)
        fams[fam] += dev_us / 1e3 / steps
        if fam == "other":
            others[key] = dev_us / 1e3 / steps
    ranges = {k: v / 1e3 / steps for k, v in spans.items()}
    parts = {}
    for key, dev_us in kernels.items():
        part = resnet_part(key)
        if part is not None:
            parts[part] = parts.get(part, 0.0) + dev_us / 1e3 / steps
    busy = sum(fams.values())
    log(f"[resnet-profile] per step: wall_ms={wall_ms} (unprofiled) "
        f"device_busy_ms={busy} device_idle_share={1 - busy / wall_ms} "
        f"({steps} profiled steps)")
    log(f"[resnet-profile] device_ms_per_step_by_family={json.dumps(fams)}")
    log(f"[resnet-profile] K7/K8 device ms per step by part: "
        f"{json.dumps(dict(sorted(parts.items())))}")
    log(f"[resnet-profile] device span per step of the TrainStep ranges: "
        f"{json.dumps(ranges)} (TrainStep.update: the Momentum update and "
        f"the parameter copies from the masters)")
    top = sorted(others.items(), key=lambda kv: -kv[1])[:10]
    log(f"[resnet-profile] largest of other, ms per step: "
        f"{json.dumps([(k[:90], v) for k, v in top])}")


def phase_resnet_training(warmup=2, timed=5, plain_timed=3):
    """ResNet-50 at 224^2, batch 256, bf16 parameters, f32 BatchNorm
    buffers, Momentum(0.1, 0.9) with f32 masters, CrossEntropyLoss, a
    fixed random batch, both flags on (bench.py's bench_resnet50 with
    the fused path): exact launches per step, a finite and falling
    loss, step time, images/s, MFU, peak memory, a profiler window; then
    both flags off for step time and images/s."""
    from paddle_tpu_torch import TrainStep, flags
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet50

    torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated()
    model = resnet50(num_classes=1000, dtype="bfloat16", seed=0).train()
    n_params = sum(p.numel() for p in model.parameters())
    ce = CrossEntropyLoss()
    step = TrainStep(model, Momentum(learning_rate=0.1, momentum=0.9,
                                     multi_precision=True),
                     lambda m, v, y: ce(m(v), y))
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(RESNET_BATCH, 3, RESNET_SIZE, RESNET_SIZE, device="cuda",
                    generator=gen).bfloat16()
    y = torch.randint(0, 1000, (RESNET_BATCH,), device="cuda", generator=gen)
    flags.set_flags({"use_fused_resnet_unit": True,
                     "use_pallas_bn_stats": True})
    try:
        losses, seconds = [], []
        _reset_resnet_counts()
        for i in range(warmup + timed):
            before = _resnet_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(x, y))        # waits for the step
            seconds.append(time.perf_counter() - t0)
            losses.append(loss)
            if i == 0:
                mem_state = torch.cuda.memory_allocated()
            after = _resnet_counts()
            got = {k: after[k] - before[k] for k in RESNET_LAUNCHES}
            check(got == RESNET_LAUNCHES, f"ResNet-50 step {i}: launches "
                  f"{got} != {RESNET_LAUNCHES}")
        counts = _resnet_counts()
        peak = torch.cuda.max_memory_allocated()
        step_s = sum(seconds[warmup:]) / timed
        ips = RESNET_BATCH / step_s
        mfu = RESNET_FLOP_PER_IMAGE * ips / PEAK_OPS_S[torch.bfloat16]
        log(f"[resnet] resnet50, 224^2, batch {RESNET_BATCH}, bf16, Momentum "
            f"with f32 masters, both flags on: params={n_params} "
            f"losses={losses}")
        log(f"[resnet] step_ms={step_s * 1e3} (mean of {timed} after "
            f"{warmup} warm-up; each {[t * 1e3 for t in seconds]}) "
            f"images_per_s={ips} mfu={mfu} (3*4.089e9*images/s over 989e12)")
        log(f"[resnet] peak_memory_bytes={peak} (allocated: before the model "
            f"{mem_base}, after the first step {mem_state})")
        log(f"[resnet] launches over {warmup + timed} steps: {counts} (per "
            f"step {RESNET_LAUNCHES})")
        check(all(np.isfinite(losses)), "non-finite ResNet-50 loss")
        check(losses[-1] < losses[0], f"ResNet-50 loss did not fall: "
              f"{losses}")
        profile_resnet_window(step, x, y, step_s * 1e3)
        flags.set_flags({"use_fused_resnet_unit": False,
                         "use_pallas_bn_stats": False})
        before = _resnet_counts()
        plain = []
        for i in range(warmup + plain_timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(x, y))
            plain.append(time.perf_counter() - t0)
            check(np.isfinite(loss), "non-finite loss with the flags off")
        check(_resnet_counts() == before, "flags off still launched K7-K9")
        plain_s = sum(plain[warmup:]) / plain_timed
        log(f"[resnet] both flags off (cuDNN convolutions, plain BatchNorm): "
            f"step_ms={plain_s * 1e3} (each {[t * 1e3 for t in plain]}) "
            f"images_per_s={RESNET_BATCH / plain_s}; flags on / off step "
            f"time {step_s / plain_s}")
    finally:
        flags.set_flags({"use_fused_resnet_unit": False,
                         "use_pallas_bn_stats": False})
    del model, step
    torch.cuda.empty_cache()
    return counts


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


def k8_only(backward):
    """``--k8-bwd`` (both directions) and ``--k8-fwd`` (the forward
    alone): build, then K8 at the main path's three 3x3 shapes: the
    check against the plain version (the forward twice, for equal bits),
    the timings beside F.conv2d / convolution_backward, the plain version
    and the bound, and the device ms of each part. Works on another
    checkout's port too (``--root``), whose K8 may live in other sources.
    Prints no result line."""
    from paddle_tpu_torch.ops.hopper import resnet_unit

    phase_device()
    log(f"[k8] implementation={os.path.dirname(resnet_unit.__file__)}")
    t0 = time.perf_counter()
    builds = [getattr(resnet_unit, f) for f in ("build", "build_conv3x3")
              if hasattr(resnet_unit, f)]
    for build in builds:
        for line in build().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] ptxas: {line.strip()}")
    log(f"[build] seconds={time.perf_counter() - t0}")
    cases = [c for c in RU_CASES if c[1] == "k8"]
    time_resnet_kernels(phase_resnet_kernels(cases, (), backward), backward)
    return 0


# --k7-bwd adds ragged rows (a last 128-row tile of 104 rows) for each
# design of K7's backward and each tile width: the one pass at 64 -> 256
# with the prologue and at 256 -> 64, the three passes with 64-wide tiles
# (192 -> 320) and with the prologue (128 -> 512)
K7_BWD_EDGES = [
    ("conv1x1_prologue_ragged_1000x64x256", "k7",
     dict(rows=1000, cin=64, cout=256, pro=True)),
    ("conv1x1_ragged_1000x256x64", "k7",
     dict(rows=1000, cin=256, cout=64, pro=False)),
    ("conv1x1_ragged_1000x192x320", "k7",
     dict(rows=1000, cin=192, cout=320, pro=False)),
    ("conv1x1_prologue_ragged_1000x128x512", "k7",
     dict(rows=1000, cin=128, cout=512, pro=True)),
]


def build_log(build):
    """Run one library's ``build`` and log ptxas's registers, spills,
    shared memory and warnings per kernel."""
    t0 = time.perf_counter()
    for line in build().splitlines():
        if "Compiling entry" in line:
            log(f"[build] ptxas: {line.split(chr(39))[1]}")
        if any(w in line for w in ("registers", "spill", "smem", "arning")):
            log(f"[build] ptxas: {line.strip()}")
    log(f"[build] seconds={time.perf_counter() - t0}")


def k7_only():
    """``--k7-bwd``: build K7's library alone (ptxas registers, spills
    and shared memory), then K7's backward at the main path's four
    shapes and at K7_BWD_EDGES: dx, dw, da, db against the plain version
    (the forward's check too, from phase 10's loop), two calls bitwise
    equal; at the four main shapes the times beside
    convolution_backward, the plain version and the bound, and the
    device ms by part. Works on another checkout's port too
    (``--root``). Prints no result line."""
    from paddle_tpu_torch.ops.hopper import resnet_unit as ru

    phase_device()
    log(f"[k7-bwd] implementation={os.path.dirname(ru.__file__)}")
    build_log(ru.build)
    gen = torch.Generator(device="cuda").manual_seed(2025)
    failures = []
    for name, kind, shape in K7_BWD_EDGES:
        c = _ru_inputs(gen, kind, shape)
        args = _bwd_args(kind, c, ru.conv1x1_bn_fwd_reference(
            c["x"], c["w"], c["a"], c["b"])[0])
        got, again = ru.conv1x1_bn_bwd_cuda(*args), ru.conv1x1_bn_bwd_cuda(*args)
        want = ru.conv1x1_bn_bwd_reference(*args)
        torch.cuda.synchronize()
        same = all(g is None or torch.equal(g, r) for g, r in zip(got, again))
        parts = []
        for key, g, wnt in zip(("dx", "dw", "da", "db"), got, want):
            if wnt is None:
                continue
            err, rel = _rel_err(g, wnt)
            tol = RU_BF16_REL if key == "dx" else RU_SUM_REL[key]
            parts.append(f"{key} max_abs_err={err} rel_to_max={rel} tol={tol}")
            if not (bool(torch.isfinite(g).all()) and rel <= tol):
                failures.append(f"{name} {key}")
        if not same:
            failures.append(f"{name} two calls differ")
        log(f"[k7-bwd] {name} {' '.join(parts)} bitwise_equal={same}")
    cases = [cs for cs in RU_CASES if cs[1] == "k7"]
    try:
        time_resnet_kernels(phase_resnet_kernels(cases, (), True), True)
    except SmokeFailure as e:
        failures.append(str(e))
    log(f"[k7-bwd] failures={failures}")
    check(not failures, f"k7-bwd: {failures}")
    return 0


def k7_fwd_only():
    """``--k7-fwd``: build K7's library alone (ptxas registers, spills
    and shared memory), then K7's forward at K7_BWD_EDGES' ragged rows,
    each with and without the prologue, and at the main path's four
    shapes: y, s1, s2 against the plain version, two calls bitwise equal;
    at the four main shapes the times back to back (``time_ms``) and by
    CUDA-graph replay (``time_ms_graph``, the device's time without the
    host's launch cost) beside torch.matmul, the plain version and the
    bound, and the device ms by part. Works on another checkout's port
    too (``--root``). Prints no result line."""
    from paddle_tpu_torch.ops.hopper import resnet_unit as ru

    phase_device()
    log(f"[k7-fwd] implementation={os.path.dirname(ru.__file__)}")
    build_log(ru.build)
    gen = torch.Generator(device="cuda").manual_seed(2026)
    fwd_k, fwd_p = ru.conv1x1_bn_fwd_cuda, ru.conv1x1_bn_fwd_reference
    edges = [(f"{name.replace('_prologue', '')}"
              f"{'_prologue' if pro else ''}", dict(shape, pro=pro))
             for name, _, shape in K7_BWD_EDGES for pro in (True, False)]
    mains = [(name, shape) for name, kind, shape in RU_CASES if kind == "k7"]
    failures = []
    for name, shape in edges + mains:
        c = _ru_inputs(gen, "k7", shape)
        args = (c["x"], c["w"], c["a"], c["b"])
        got, again, want = fwd_k(*args), fwd_k(*args), fwd_p(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(g, r) for g, r in zip(got, again))
        parts = []
        for key, g, wnt in zip(("y", "s1", "s2"), got, want):
            err, rel = _rel_err(g, wnt)
            tol = RU_BF16_REL if key == "y" else RU_SUM_REL[key]
            parts.append(f"{key} max_abs_err={err} rel_to_max={rel} tol={tol}")
            if not (bool(torch.isfinite(g).all()) and rel <= tol):
                failures.append(f"{name} {key}")
        if not same:
            failures.append(f"{name} two calls differ")
        log(f"[k7-fwd] {name} {' '.join(parts)} bitwise_equal={same}")
        del got, again, want
        if (name, shape) not in mains:
            continue
        x, w = c["x"], c["w"]
        (bound, by), _ = _ru_bounds("k7", c)
        t = dict(ms=time_ms(lambda: fwd_k(*args)),
                 graph_ms=time_ms_graph(lambda: fwd_k(*args)),
                 plain_ms=time_ms(lambda: fwd_p(*args), iters=3, warmup=1),
                 library_ms=time_ms(lambda: torch.matmul(x, w)),
                 library_graph_ms=time_ms_graph(lambda: torch.matmul(x, w)))
        log(f"[time] k7 fwd {name} device ms per launch by part: "
            f"{json.dumps(ru_parts(fwd_k, args))}")
        log(f"[time] k7 fwd {name} ms={t['ms']} graph_ms={t['graph_ms']} "
            f"plain_ms={t['plain_ms']} library_ms={t['library_ms']} "
            f"library_graph_ms={t['library_graph_ms']} (torch.matmul) "
            f"bound_ms={bound} ({by}) bound_share={bound / t['graph_ms']}")
        del c, args
        torch.cuda.empty_cache()
    log(f"[k7-fwd] failures={failures}")
    check(not failures, f"k7-fwd: {failures}")
    return 0


# --flash-fwd and --flash-bwd add the 128-row tile edges to the bf16
# FLASH_CASES: a q tile with no full 128 rows, one and a half tiles, a
# ragged key end under a non-causal mask, and d=64 with GQA
FLASH_FWD_EDGES = [
    ("causal_s100_h8_kv2_d128_bf16", torch.bfloat16, 2, 100, 100, 8, 2, 128,
     True),
    ("causal_s192_h8_d128_bf16", torch.bfloat16, 2, 192, 192, 8, 8, 128, True),
    ("noncausal_sq200_sk1000_bf16", torch.bfloat16, 2, 200, 1000, 8, 8, 128,
     False),
    ("d64_gqa_h16_kv4_s520_bf16", torch.bfloat16, 1, 520, 520, 16, 4, 64,
     True),
]


def flash_fwd_only():
    """``--flash-fwd``: build the flash library alone (ptxas registers,
    spills and shared memory), then the bf16 forward at every bf16
    FLASH_CASE and the tile edges: out and lse against the plain forward,
    two calls bitwise equal, and its time (CUDA events) beside SDPA's and
    the bound. Works on another checkout's port too (``--root``). Prints
    no result line."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    phase_device()
    log(f"[flash-fwd] implementation={os.path.dirname(fa.__file__)}")
    build_log(fa.build)
    gen = torch.Generator(device="cuda").manual_seed(4321)
    for name, dt, b, sq, sk, h, kv, d, causal in FLASH_CASES + FLASH_FWD_EDGES:
        if dt != torch.bfloat16:
            continue
        q, k, v = (torch.randn(b, n, heads, d, device="cuda",
                               generator=gen).to(dt)
                   for n, heads in ((sq, h), (sk, kv), (sk, kv)))
        scale = 1.0 / d ** 0.5
        out, lse = fa.flash_attention_fwd_cuda(q, k, v, causal, scale)
        out2, lse2 = fa.flash_attention_fwd_cuda(q, k, v, causal, scale)
        want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                              scale)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all() and torch.isfinite(lse).all()),
              f"flash-fwd {name}: not finite")
        err = float((out.float() - want_out.float()).abs().max())
        tol = FLASH_BF16_REL * float(want_out.float().abs().max())
        row_err = flash_row_err(out, want_out)
        lse_err = float((lse - want_lse).abs().max())
        same = bool(torch.equal(out, out2) and torch.equal(lse, lse2))
        log(f"[flash-fwd] {name} out max_abs_err={err} tol={tol} "
            f"worst_row_rel_err={row_err} row_tol={FLASH_BF16_REL} lse "
            f"max_abs_err={lse_err} tol={FLASH_LSE_ATOL} bitwise_equal={same}")
        check(err <= tol, f"flash-fwd {name}: out disagrees")
        check(row_err <= FLASH_BF16_REL, f"flash-fwd {name}: a row of out "
              f"disagrees")
        check(lse_err <= FLASH_LSE_ATOL, f"flash-fwd {name}: lse disagrees")
        check(same, f"flash-fwd {name}: two calls differ")
        ms = time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, causal,
                                                         scale))
        g = h // kv
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (
            q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
        lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal))
        bound, by = flash_bound(dict(q=q, k=k, causal=causal), "fwd")
        log(f"[flash-fwd] {name} ms={ms} sdpa_ms={lib_ms} bound_ms={bound} "
            f"({by}) x_sdpa={ms / lib_ms} bound_share={bound / ms}")
        del q, k, v, out, out2, lse, lse2, want_out, want_lse, qt, kt, vt
    torch.cuda.empty_cache()
    return 0


def flash_bwd_only():
    """``--flash-bwd``: build the flash library alone (ptxas registers,
    spills and shared memory), then the bf16 dq and dkv kernels at every
    bf16 FLASH_CASE and the tile edges: dq, dk and dv against the plain
    backward (to FLASH_BF16_REL of the largest value and to
    FLASH_GRAD_ROW_REL of each row's, FLASH_ROW_FLOOR at least; the worst
    row logged), two calls bitwise equal, and the times (CUDA
    events) of dq, dkv, their sum and the whole ``flash_attention_bwd_cuda``
    (delta included) beside SDPA's backward and the bound. Works on
    another checkout's port too (``--root``). Every case runs; the
    failures are reported together at the end. Prints no result line."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    phase_device()
    log(f"[flash-bwd] implementation={os.path.dirname(fa.__file__)}")
    build_log(fa.build)
    gen = torch.Generator(device="cuda").manual_seed(4321)
    failures = []
    for name, dt, b, sq, sk, h, kv, d, causal in FLASH_CASES + FLASH_FWD_EDGES:
        if dt != torch.bfloat16:
            continue
        q, k, v, do = (torch.randn(b, n, heads, d, device="cuda",
                                   generator=gen).to(dt)
                       for n, heads in ((sq, h), (sk, kv), (sk, kv), (sq, h)))
        scale = 1.0 / d ** 0.5
        out, lse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, do, lse, delta, causal, scale)
        got = (fa.flash_attention_dq_cuda(*args),
               *fa.flash_attention_dkv_cuda(*args))
        again = (fa.flash_attention_dq_cuda(*args),
                 *fa.flash_attention_dkv_cuda(*args))
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                                scale)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        parts = []
        for key, x, w in zip(("dq", "dk", "dv"), got, want):
            err = float((x.float() - w.float()).abs().max())
            tol = FLASH_BF16_REL * float(w.float().abs().max())
            row_err = flash_row_err(x, w, FLASH_ROW_FLOOR)
            parts.append(f"{key} max_abs_err={err} tol={tol} "
                         f"worst_row_rel_err={row_err}")
            if not (bool(torch.isfinite(x).all()) and err <= tol
                    and row_err <= FLASH_GRAD_ROW_REL):
                failures.append(f"{name} {key}")
        if not same:
            failures.append(f"{name} two calls differ")
        log(f"[flash-bwd] {name} {' '.join(parts)} row_tol="
            f"{FLASH_GRAD_ROW_REL} bitwise_equal={same}")
        dq_ms = time_ms(lambda: fa.flash_attention_dq_cuda(*args))
        dkv_ms = time_ms(lambda: fa.flash_attention_dkv_cuda(*args))
        whole, delta_ms = time_flash_bwd_whole(dict(
            q=q, k=k, v=v, do=do, out=out, lse=lse, causal=causal,
            scale=scale))
        g = h // kv
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k.repeat_interleave(g, 2),
                                v.repeat_interleave(g, 2)))
        lib_out = sdpa(qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2).contiguous()
        lib_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True))
        m = dict(q=q, k=k, causal=causal)
        bq, bkv = flash_bound(m, "dq")[0], flash_bound(m, "dkv")[0]
        log(f"[flash-bwd] {name} dq_ms={dq_ms} dkv_ms={dkv_ms} pair_ms="
            f"{dq_ms + dkv_ms} whole_ms={whole} delta_ms={delta_ms} "
            f"sdpa_bwd_ms={lib_ms} x_sdpa={(dq_ms + dkv_ms) / lib_ms} "
            f"bound_ms dq={bq} dkv={bkv} (operations) bound_share dq="
            f"{bq / dq_ms} dkv={bkv / dkv_ms} pair="
            f"{(bq + bkv) / (dq_ms + dkv_ms)}")
        del q, k, v, do, out, lse, delta, args, got, again, want, qt, kt, vt
        del lib_out, dot
        torch.cuda.empty_cache()
    log(f"[flash-bwd] failures={failures}")
    check(not failures, f"flash-bwd: {failures}")
    return 0


def k5_only():
    """``--k5``: build K5 alone, then check and time it at every case:
    the timings beside SDPA and the bound, the device ms of its split
    and merge kernels, the wrapper's host microseconds per call, and
    (where the wrapper has them) both bodies at span widths 64, 128,
    256, 512 and the kernel's own choice. Prints no result line."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    phase_device()
    log(f"[k5] implementation={os.path.dirname(pa.__file__)}")
    t0 = time.perf_counter()
    for line in pa.build().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] ptxas: {line.strip()}")
    log(f"[build] seconds={time.perf_counter() - t0}")
    results = phase_k5()
    k5_host_us(results)
    time_k5(results, keep=True)
    k5_parts(results)
    if hasattr(pa, "_launch"):
        k5_host_parts(results)
        k5_sweep(results)
    return 0


def norms_host_parts():
    """Host microseconds of each part of a K6 call at 8 x 4096 and of a
    K9 call at 12,544 x 2048 (the least of 5 rounds of 100 back-to-back
    calls, enqueue only): the checks, each allocation, the stream lookup,
    the library call (K6 also without its launch: ctypes alone), the
    whole wrapper, and the library function for the same work
    (F.rms_norm, torch.var_mean)."""
    from paddle_tpu_torch.ops.hopper import bn_stats as bn
    from paddle_tpu_torch.ops.hopper import rms_norm as rn

    gen = torch.Generator(device="cuda").manual_seed(5)
    x, w = k6_inputs(gen, 8, 4096, torch.bfloat16)
    out, rstd = rn.rms_norm_cuda(x, w, 1e-5)
    lib = rn._library()
    dev = x.get_device()
    device = x.device
    xb = torch.randn(12544, 2048, device="cuda", generator=gen).bfloat16()
    sms = bn._sm_count(dev)
    plan = bn.bn_stats_plan(12544, 2048, sms)
    part = torch.empty((plan["parts"], 2, 2048), device="cuda")
    stats = torch.empty((2, 2048), device="cuda")
    blib = bn._library()
    parts = {
        "k6": {
            "check": lambda: rn._check(x, w),
            "empty_like": lambda: torch.empty_like(x),
            "empty_rstd": lambda: torch.empty((8, 1), device=device,
                                              dtype=torch.float32),
            "stream": lambda: torch._C._cuda_getCurrentRawStream(dev),
            "library_call_no_launch": lambda: lib.rms_norm_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), rstd.data_ptr(),
                0, 4096, 1, 1e-5, dev,
                torch._C._cuda_getCurrentRawStream(dev)),
            "library_call": lambda: lib.rms_norm_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), rstd.data_ptr(),
                8, 4096, 1, 1e-5, dev,
                torch._C._cuda_getCurrentRawStream(dev)),
            "wrapper": lambda: rn.rms_norm_cuda(x, w, 1e-5),
            "F.rms_norm": lambda: torch.nn.functional.rms_norm(
                x, (4096,), w, 1e-5),
        },
        "k9": {
            "check": lambda: bn._check(xb),
            "plan": lambda: bn.bn_stats_plan(12544, 2048, bn._sm_count(dev)),
            "empty": lambda: torch.empty((plan["parts"] + 1, 2, 2048),
                                         device=device, dtype=torch.float32),
            "library_call": lambda: blib.bn_stats_launch(
                xb.data_ptr(), part.data_ptr(), stats.data_ptr(),
                stats.data_ptr() + 4 * 2048, 12544, 2048, 1, sms, dev,
                torch._C._cuda_getCurrentRawStream(dev)),
            "wrapper": lambda: bn.bn_stats_cuda(xb),
            "torch.var_mean": lambda: torch.var_mean(xb, dim=0),
        },
    }
    for kernel, fns in parts.items():
        us = {name: host_us(fn)[0] for name, fn in fns.items()}
        log(f"[norms-host] {kernel} parts_us_per_call={json.dumps(us)}")


def norms_only():
    """``--norms``: build K6's and K9's libraries alone (ptxas registers,
    spills and shared memory), then every case of phase 3 (K6) and of
    phase 10 (K9) against the plain version, two calls bitwise equal, and
    at the main shapes the times back to back and by CUDA-graph replay
    beside the library call (F.rms_norm, torch.var_mean), the plain
    version and the bound, and the wrapper's host microseconds per call.
    Every case runs; the failures are reported together at the end. Works
    on another checkout's port too (``--root``; one whose kernels need no
    build step is built by its first launch). Prints no result line."""
    from paddle_tpu_torch.ops.hopper import bn_stats as bn
    from paddle_tpu_torch.ops.hopper import rms_norm

    phase_device()
    log(f"[norms] implementation={os.path.dirname(rms_norm.__file__)}")
    for mod in (rms_norm, bn):
        if hasattr(mod, "build"):
            build_log(mod.build)
    failures = []
    time_k6(phase_k6(failures))
    gen = torch.Generator(device="cuda").manual_seed(2024)
    for name, rows, ch, dtype, main in K9_CASES:
        x = (torch.randn(rows, ch, device="cuda", generator=gen) * 2
             + 1.5).to(dtype)
        _, failure = k9_check(name, x)
        if failure:
            failures.append(failure)
        if main:
            time_k9(x)
        del x
        torch.cuda.empty_cache()
    if hasattr(rms_norm, "_check"):
        norms_host_parts()
    log(f"[norms] failures={failures}")
    check(not failures, f"norms: {failures}")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "on the card", file=sys.stderr)
        return 2
    argv = sys.argv[1:]
    root = HERE
    if argv[:1] in (["--k5"], ["--k8-fwd"], ["--flash-fwd"],
                    ["--flash-bwd"], ["--k7-fwd"], ["--k7-bwd"],
                    ["--norms"]) \
            and argv[1:2] == ["--root"] \
            and len(argv) == 3:
        # another checkout's port (an earlier commit's), timed the same way
        root, argv = os.path.abspath(argv[2]), argv[:1]
    sys.path.insert(0, root)
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    if argv in (["--k8-bwd"], ["--k8-fwd"]):
        return k8_only(backward=argv == ["--k8-bwd"])
    if argv == ["--k5"]:
        return k5_only()
    if argv == ["--flash-fwd"]:
        return flash_fwd_only()
    if argv == ["--flash-bwd"]:
        return flash_bwd_only()
    if argv == ["--k7-fwd"]:
        return k7_fwd_only()
    if argv == ["--k7-bwd"]:
        return k7_only()
    if argv == ["--norms"]:
        return norms_only()
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
    t_resnet = time.perf_counter()
    ru_results = phase_resnet_kernels()
    ru_errs = {k: v["errs"] for k, v in ru_results.items()}
    ru_times = time_resnet_kernels(ru_results)
    phase_block_parity()
    resnet = phase_resnet_training()
    t_resnet = time.perf_counter() - t_resnet
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    pallas = "paddle_tpu/ops/pallas/flash_attention.py"
    shape = FLASH_CASES[0][0]
    kernels = [
        k5_entry(k5_launches, k5),
        dict(kernel_entry("rms_norm", "cuda",
                          "paddle_tpu_torch/csrc/rms_norm.cu",
                          "paddle_tpu/ops/pallas/rms_norm.py:55",
                          k6_launches, k6, "rows8_h4096"),
             graph_ms=k6["rows8_h4096"]["graph_ms"],
             host_us=k6["rows8_h4096"]["host_us"],
             other_shapes={k: {f: r[f] for f in (
                 "ms", "graph_ms", "library_ms", "library_graph_ms",
                 "bound_ms", "host_us")} for k, r in k6.items()
                 if r["main"] and k != "rows8_h4096"}),
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
    ru_src = "paddle_tpu_torch/csrc/resnet_unit.cu"
    k8_src = "paddle_tpu_torch/csrc/conv3x3_bn.cu"
    ru_pallas = "paddle_tpu/ops/pallas/resnet_unit.py"
    for kname, kind, d, line, err_key, source in (
            ("resnet_unit_conv1x1_fwd", "k7", "fwd", 103, "y", ru_src),
            ("resnet_unit_conv1x1_bwd", "k7", "bwd", 201, "dx", ru_src),
            ("resnet_unit_conv3x3_fwd", "k8", "fwd", 354, "y", k8_src),
            ("resnet_unit_conv3x3_bwd", "k8", "bwd", 433, "dx", k8_src)):
        cases = [c for c, kd, _ in RU_CASES if kd == kind]
        kernels.append(dict(
            timed_entry(kname, "cuda", source, f"{ru_pallas}:{line}",
                        resnet[f"{kind}_{d}"],
                        max(ru_errs[c][err_key] for c in cases),
                        ru_times[cases[0]][d], cases[0]),
            other_shapes={c: ru_times[c][d] for c in cases[1:]}))
    k9_cases = [f"k9_{c[0]}" for c in K9_CASES]
    k9_main = [f"k9_{c[0]}" for c in K9_CASES if c[4]]
    kernels.append(dict(
        timed_entry("bn_stats", "cuda", "paddle_tpu_torch/csrc/bn_stats.cu",
                    "paddle_tpu/ops/pallas/bn_stats.py:59", resnet["k9"],
                    max(max(ru_errs[c].values()) for c in k9_cases),
                    ru_times[k9_main[0]]["k9"], K9_CASES[0][0]),
        graph_ms=ru_times[k9_main[0]]["k9"]["graph_ms"],
        host_us=ru_times[k9_main[0]]["k9"]["host_us"],
        other_shapes={c: ru_times[c]["k9"] for c in k9_main[1:]}))
    log(f"[done] seconds={time.perf_counter() - t_start} (of which the "
        f"ResNet phases 10-12: {t_resnet})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
