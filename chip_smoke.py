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
``python3 chip_smoke.py --tier`` runs the host tier and the robustness
contract alone: K5 and K6 built, phase 6's host-tier and fault checks,
then phases 7d and 7e.
``python3 chip_smoke.py --fleet`` runs the serving fleet alone: K5 and
K6 built, phase 6's fleet checks, then phase 7g.
``python3 chip_smoke.py --int8`` is the quick loop for K10 (the
weight-only int8 matmul): its build's ptxas report, every case of phase
5b against the plain version (two calls bitwise equal) and its timings,
the wrapper's host microseconds by part and every split of K the C call
takes at phase 5b's shapes, then K5 and K6
built, phase 6's int8 gate and phase 7h; ``--int8-kernel`` stops after
the kernel loop. Both take ``--root DIR`` (another checkout's port).
``python3 chip_smoke.py --families`` builds the flash, K5 and K10
libraries and runs phase 13 alone (the transformer families).
``python3 chip_smoke.py --unet`` builds the flash library and runs phase
14 alone (the Stable-Diffusion UNet). ``python3 chip_smoke.py --amp``
builds the flash and K6 libraries and runs phase 15 alone (amp).

Phases, in order; each one checks its own results and any failure ends
the run with a non-zero exit code and no result line:

1. Device: name, count, ``nvidia-smi`` name and power limit; build the
   kernels from the checkout's sources (one nvcc per CUDA source, all
   seven started together).
2. K5 (ragged paged attention, CUDA) against its plain version on the
   same bf16 pool: decode at mixed depths with an idle row, prefill at
   position 0 and 256, a ragged 100-row chunk, GQA decode, decode at
   phase 7's depths, rows whose horizon ends one column before, on and
   after a span boundary with the full table and an idle row, an f32
   pool; speculative verify rows [8, 8] with an idle slot, a prefill
   chunk from position 191 (after a capped prefix hit), and the draft
   model's decode and 128-row catch-up at 32 heads over 4 KV heads,
   head_dim 64; two calls give equal bits (the fixed-order merge).
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
5b. K10 (weight-only int8 matmul, CUDA) against its plain version at
   Llama-2-7B's linear shapes (4096 -> 4096, 4096 -> 11008, 11008 ->
   4096, 4096 -> 32000) with 1, 8, 64, 128 and 512 rows, in bf16 and
   f32, and at ragged rows (37, 300, and 45 in f32) and the row tiles'
   edges 16, 17 and 129 at 4096 -> 11008; two calls bitwise equal; an N
   that is not a multiple of 16 raises. The bf16 cases timed by CUDA
   events and by CUDA-graph replay beside ``torch.matmul`` on the same
   weight in bf16 (the product quantization replaces), the plain
   version and the bound, with the wrapper's host microseconds a call
   (and by part at the decode shape).
6. Serving parity at Llama-2-7B width, 2 layers, f32: engine greedy
   tokens (kernels) equal dense ``generate`` tokens, with the default
   engine (prefix cache on); a shared-prefix set (4 prompts on one
   40-token prefix and an exact resubmit, which copies a block on write)
   with caching on and off; a repeat-heavy set under n-gram speculation
   and under a 2-layer f32 draft model of TinyLlama's widths. A mismatch
   logs the dense path's top-2 logit gap. Then bench.py's zipf-hosttier
   mix reduced (12 requests, 3 system prompts of 64 tokens, suffixes of
   1-8, 8 new, a cached set of 4 blocks), sequential, in its three runs
   (device, host, cold): tokens equal dense greedy in all three, host
   computes as many tokens as device and cold more; the host run again
   under ``serving.decode:times=1`` and under
   ``serving.host_tier.restore:times=1``: the fault-free tokens, every
   outcome ok, the reference's retries, a clean pool. Then the default
   engine with ``FLAGS_telemetry`` on: the telemetry-off tokens, a span a
   step, a timeline a request; and the request handoff: one request moved
   to a second engine after 4 decode tokens and one in mid-prefill (a
   200-token prompt, two chunks), their tokens equal the unmoved run and
   the imported blocks byte-equal the manifest. Then the fleet: 2
   replicas give the single engine's tokens on phase 6's prompts and a
   seeded stochastic request; replica 1 killed once at its third step
   loses nothing and respawns through JOINING; a 1:1 prefill/decode
   fleet hands every request off once and gives the monolithic tokens
   with speculation off and n-gram; ``migrate_one`` moves one request
   mid-decode and one mid-prefill and their tokens equal the unmoved
   run; launches exact. Last, the int8 gate on the same model:
   ``quantize_for_decode`` on the card gives the int8 bytes and scales
   of the CPU's, linear weights fall to a quarter of f32's (the card
   frees the difference), and the engine's greedy tokens (K5, K6, K10:
   15 launches a dispatch) equal dense ``generate``'s on the quantized
   model. After the phase the card holds no more than it did before it
   (no cycle collection).
7. Serving at full Llama-2-7B (bf16, 32 layers; block 16, 8 slots,
   prefill chunk 128): 8 requests through the engine; throughput,
   TTFT/TPOT, peak memory, exact launch counts; then a short
   torch.profiler window: device time by kernel family and the device's
   idle share; then one prefill and one decode-only dispatch from the
   window replayed under the profiler, by family and with K5's split and
   merge kernels apart. Then (a) bench.py's shared-prefix mix (32
   requests on 4 system prompts of 192 tokens, Zipf 1.2, plus 4 exact
   resubmits, 32 new tokens where bench.py has 64, one burst) with
   caching on and off; (b) its
   repeat-heavy mix (32 requests, a 16-token pattern tiled 8 times, 32
   new tokens where bench.py has 128, token budget 512) with n-gram
   speculation and without; (c) 4 of those requests, 32 new tokens,
   with a bf16 draft model of TinyLlama-1.1B's geometry (22 layers,
   random weights). Each run logs
   TTFT, TPOT, tokens/s, peak memory, prefix and speculation counters,
   and holds its launches to K5 = 32 x target + 22 x draft dispatches and
   K6 = 65 x target + 45 x draft dispatches. (d) bench.py's on-chip
   zipf-hosttier mix (the first 16 of its 48 requests, 8 system prompts
   of 192 tokens, suffixes of 1-32, RandomState(7); 16 new where
   bench.py has 32) in a
   sequential closed loop,
   three runs: device (unbounded cached set, a pool that holds
   everything), host (a cached set of 24 blocks, the host tier on with 1
   GiB), cold (24 blocks, tier off): host tokens equal device tokens,
   host computes as many tokens as device, spills and host hits happen,
   one spilled bf16 block round-trips byte-equal, launches exact; each
   run's ``[serve:7d-<run>]`` lines add one block's D2H and H2D ms (CUDA
   events). (e) the robustness contract on phase 7's mix, by counts and
   states: ``serving.decode:times=1`` and ``serving.prefill:times=1``
   (every request ok, one replay for each request of the failing plan,
   SERVING -> DEGRADED -> SERVING after 8 clean steps, exact launches),
   ``serving.host_tier.restore:times=1`` in a short 7d-style run (one
   restore failure, no retry, no leaked block), a deadline shorter than
   the decode (``expired`` with partial output), a cancel in flight,
   ``serving_max_queue=4`` with 8 arrivals (4 ``queue_full`` sheds) and
   ``drain()`` to STOPPED. (f) telemetry on phase 7's mix with
   ``hbm_peak_gbs`` at the card's HBM peak, telemetry off, on, on, off:
   the on tokens equal the off ones and the main run's, launches exact,
   the counters agree with the engine (steps, 8 requests, 8 ok, the
   ledger's kinds sum to the tokens computed, goodput ratio 1.0), a span a
   step, the Chrome trace (a row a request) and the Prometheus text
   parse; ``serving.decode:times=1`` writes exactly one flight dump that
   names the failing step; one request handed off mid-decode to an engine
   with its own pool finishes ok with byte-equal blocks. ``[serve:7f]``
   lines give the wall time a dispatch and tok/s on and off, a span's
   host µs off and on, the decode roofline, the attention-bytes share and
   the handoff's bytes and ms, beside the card's name and power limit.
   (g) the serving fleet, every replica over the one model with a pool
   of 512 blocks (4 GiB): (i) 2 monolithic replicas on bench.py fleet's
   on-chip mix (32 requests, 4 system prompts of 192 tokens, 64 new,
   Poisson arrivals at 8/s on the wall clock) against one engine; (ii)
   the same with the seed wave in one burst (so that both replicas
   serve) and replica 1 killed at its ninth step and healed through
   JOINING (card memory back within a block of its level before the
   death, without the cycle collector; the death dump names the in-flight
   rids); (iii) a 1:1 prefill/decode fleet on the first 16 requests (every
   request handed off once); (iv) bench.py fleet ramp's on-chip profile
   (128-token prompts, 32 new, 2/s, 16/s, 2/s over 8 + 6 + 8 s) with the
   autoscaler and migration on, one busy replica retired mid-burst with
   no drain budget (scale-ups, scale-downs, migrations); (v) a replica
   hung for 8 s under a 5 s step budget while both step on threads of
   their own; (vi) the first 16 requests in one burst (32 new) on two
   replicas stepped inline, then on threads. Zero loss and exact
   launches in every run; ``[serve:7g-*]`` lines give tok/s, TTFT and
   TPOT (per replica in
   (i)), the routed split, the respawn's seconds, the handoff's bytes
   and ms, the scale events and migrations, and the fleet step's wall ms
   inline against threaded on the same steps, prefill and decode steps
   apart, beside the card's name and power limit. (h) the model of
   phase 7 in bf16, then quantized in place with ``quantize_for_decode``:
   ``generate`` decode tok/s at batch 1 and 8 (a 128-token prompt, 128
   new, as bench.py's ``int8_speedup``) and phase 7's mix through the
   engine, each both ways, with exact launches (K10 = 225, K5 = 32, K6 =
   65 a dispatch), zero loss, linear weight bytes, tok/s, TTFT, TPOT and
   the decode step against the int8 weights' bound (1.97 ms).
8. Training parity at Llama-2-7B width, 2 layers, f32, b=1, s=256: the
   loss and every parameter's gradient on the card (kernels) against
   the CPU (plain versions), also under per-layer recompute with each
   granularity (full, core_attn, full_attn); then a 3-step TrainStep loss
   trajectory, and 3 more steps under LinearWarmup over
   CosineAnnealingDecay with a ``grad_postprocess``.
9. Training at Llama-2-7B widths, 8 layers, bf16, AdamW with f32
   masters, batch 2 x 4096: 2 warm-up and 5 timed TrainSteps; step
   time, tokens/s, MFU, peak memory, exact launch counts per step, a
   falling loss; then a torch.profiler window as for serving. Then the
   same steps with ``recompute=True`` (granularity full): 16 flash
   forwards and 33 K6 forwards a step, the plain run's losses, a lower
   peak memory, step time and tokens/s.
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
13. The transformer families beside Llama, at full width: (a) K1-K4 at
    BERT-base's non-causal b=32 s=512 h=12 d=64, DiT-XL/2's non-causal
    b=32 s=256 h=16 d=72 (zero-padded to 128) and GPT-2 small's causal
    b=8 s=1024 h=12 d=64, bf16: out, lse, dq, dk, dv against the plain
    versions, row by row, equal bits over two backward calls; timed
    (wrappers, kernels alone, plain, SDPA, bounds; d=72 also at d=64).
    (b) K5 at GPT-2 small's decode (8 slots, 12 x 64, MHA) and K10 at
    its four linear shapes (768 -> 2304, 768, 3072; 3072 -> 768) against
    their plain versions, timed. (c) GPT-2 small serving (``GPTConfig()``,
    random weights from seed 0): in f32 the engine's greedy tokens equal
    dense ``generate``'s, dense and after ``quantize_for_decode`` (K10 48
    a dispatch, the head dense); in bf16 phase 7's mix, then quantized:
    zero loss, exact launches (K5 12 a dispatch, K6 none), tok/s, TTFT,
    TPOT. (d) GPT-2 small, BERT-base and DiT-XL/2 at full width cut to 2
    layers, f32: the loss and every gradient on the card against the
    CPU, and 2 AdamW TrainSteps. (e) Training at full width and depth,
    bf16, AdamW with f32 masters, 2 warm-up and 5 timed steps: GPT-2
    small at 8 x 1024, BERT-base (fused MLM head) at seq 512 and the
    first of batch 64/48/32/16 that fits, DiT-XL/2 (32^2 latents, 256
    tokens) at the first of batch 32/16/8 that fits; one flash forward,
    one dq and one dkv a layer a step (12 / 12 / 28), a falling loss,
    step ms, tokens/s (samples/s), MFU by bench.py's formulas, peak
    memory and a torch.profiler window each.
14. The Stable-Diffusion UNet (``models.UNet2DConditionModel``, heads of
    8, which K1-K4 take zero-padded to 64): (a) K1-K4 at SD v1.5's
    attention shapes, batch 1, non-causal, d=8: self-attention at 4096,
    1024, 256 and 64 tokens (40, 80, 160, 160 heads) and cross-attention
    of each against 77 text tokens (a ragged key tile), in f32, the two
    4096-query shapes in bf16 too, then d=32 (f32, padded to 64) and
    d=100 (bf16, padded to 128): out, lse, dq, dk, dv against the plain
    versions, equal bits over two calls, timed (wrappers with their
    padding, kernels alone, plain, SDPA) against the largest of the
    bytes, the products and the exponentials over the SFU's ex2 rate.
    (b) A UNet of SD v1.5's widths cut to two levels (320, 640; one layer
    a block; 32^2 latents), f32, TF32 off, weights built on the CPU: the
    loss and every gradient on the card against the CPU, and 2 AdamW
    TrainSteps. (c) SD v1.5 (``UNetConfig()``) trained in f32 with AdamW
    (lr 1e-4) at the first of batch 8/4/2 that fits, 64^2 latents and a
    77 x 768 context: exactly 32 flash forwards, 32 dq and 32 dkv a step
    (16 TransformerBlocks), a falling loss, step ms, samples/s, MFU (3 x
    the forward's FLOPs at the true widths over the f32 peak), peak
    memory, and a torch.profiler window by family (flash, conv,
    GroupNorm, matmul, elementwise) with the idle share.
15. amp (``paddle_tpu_torch.amp``): (a) K1-K4 in fp16 at Llama-2-7B's
    training shape (b=2 s=4096 h=32 d=128, causal) and SD v1.5's
    4096-token self-attention (d=8 padded to 64), then head_dim 256 in
    f32, bf16 and fp16 (b=1 s=2048 h=8 causal and non-causal, a ragged
    2048 x 77, d=160 padded to 256): out, lse, dq, dk, dv against the
    plain versions (fp16 to its own limits), equal bits over two calls,
    timed against the bound and SDPA. (b) Card against CPU under
    ``auto_cast``: the tiny UNet through ``TrainStep`` under O1 and O2
    bf16, the tiny Llama eager under O1 fp16 with a ``GradScaler``: the
    loss and every gradient. (c) SD v1.5 with f32 parameters trained
    under ``auto_cast(level="O1")`` (bf16) with AdamW at the first of
    batch 8/4/2 that fits: exactly 32 bf16 flash forwards, 32 dq and 32
    dkv a step (the wrappers' counts by form: type and head width), a
    falling loss, step ms, samples/s, MFU over the bf16 peak, peak memory
    and a profile window. (d) Llama-2-7B's widths at 8 layers, f32 weights,
    eager under ``auto_cast(level="O1", dtype="float16")`` with
    ``GradScaler(init_loss_scaling=65536)``: 8/8/8 fp16 flash launches
    and 17 f32 K6 forwards a step, the scale after each step, at least
    one applied step, a finite loss.
16. One ``kernels`` JSON line.
17. The result line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or the JAX package. Without a CUDA device it
exits with code 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import types
import weakref
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
# fp16 keeps 3 more mantissa bits than bf16 (and the kernels round P and
# dS to fp16): the bf16 limits over 4, a factor of 2 short of the 8 those
# bits give
FLASH_F16_REL = 2.0 ** -8
FLASH_F16_GRAD_ROW_REL = 2.0 ** -7
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


def release_device_memory():
    """Hand the cached blocks of what dropped objects held back to the
    card. No cycle collection is needed: an engine (speculating or not), a
    replica the fleet let go of and a dropped fleet are freed by reference
    counting as their last reference goes (phase 7g (ii) and the checks
    after phases 6 and 7 hold it)."""
    torch.cuda.empty_cache()


def check_released(label, base, slack=1 << 30):
    """After a phase dropped its models and engines: the card holds at
    most ``slack`` bytes more than ``base``, without the cycle
    collector."""
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - base
    log(f"[memory] after {label}: {left} bytes above its start")
    check(left <= slack, f"{label}: {left} bytes are still allocated on the "
          f"card after every object of the phase was dropped (a reference "
          f"cycle?)")


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
                                             int8_matmul, paged_attention,
                                             resnet_unit, rms_norm)

    t0 = time.perf_counter()
    builds = (paged_attention.build, flash_attention.build, resnet_unit.build,
              resnet_unit.build_conv3x3, rms_norm.build, bn_stats.build,
              int8_matmul.build)
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        nvcc_logs = list(pool.map(lambda build: build(), builds))
    t_all = time.perf_counter() - t0
    for nvcc_log in nvcc_logs:
        log_ptxas(nvcc_log)
    log(f"[build] seconds={t_all}")


def log_ptxas(nvcc_log):
    """Each kernel's ptxas lines of one build log: its name, registers,
    spills, shared memory and C75xx notes."""
    for line in nvcc_log.splitlines():
        if "Compiling entry" in line:
            log(f"[build] ptxas: {line.split(chr(39))[1]}")
        if any(w in line for w in ("registers", "spill", "smem", "C75")):
            log(f"[build] ptxas: {line.strip()}")


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
    draft = dict(h=32, kv=4, d=64, bs=16, max_blocks=mb)
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
        # speculative verify rows: the last token + 7 drafts per slot at
        # phase 7's depths, slot 3 idle (its 8 queries read scratch); the
        # engine reads only each row's first 1 + k outputs, the rest are
        # padding queries that must stay finite
        "verify_b8_s8": k5_case(gen, b=8, s=8, positions=serving_depths(),
                                idle=(3,), **mha),
        # a prefill chunk after a capped prefix hit on a 192-token prompt:
        # it starts on the last row of the 12th block
        "prefill_s32_pos191": k5_case(gen, b=1, s=32, positions=[191],
                                      **mha),
        # the draft model (TinyLlama's geometry: 32 heads over 4 KV heads,
        # head_dim 64) over the target's tables: decode and catch-up
        "draft_decode_b8_h32_kv4_d64": k5_case(
            gen, b=8, s=1, positions=serving_depths(), idle=(0,), **draft),
        "draft_prefill_s128_h32_kv4_d64": k5_case(
            gen, b=1, s=128, positions=[128], **draft),
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
    from paddle_tpu_torch.ops.hopper._build import count_launch
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
        # the launch count's own share of that: one lock a launch
        before = rms_norm_cuda.launches
        count_us = host_us(lambda: count_launch(rms_norm_cuda))[0]
        rms_norm_cuda.launches = before
        log(f"[time] k6 {name} ms={r['ms']} graph_ms={r['graph_ms']} "
            f"plain_ms={r['plain_ms']} library_ms={r['library_ms']} "
            f"library_graph_ms={r['library_graph_ms']} bound_ms="
            f"{r['bound_ms']} ({r['bound_by']}) bound_share="
            f"{r['bound_ms'] / r['graph_ms']}")
        log(f"[k6-host] {name} host_us_per_call min={us_min} "
            f"median={us_med} rounds={us} launch count (lock) "
            f"us_per_call min={count_us}")


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


def flash_check(name, q, k, v, do, causal, scale):
    """One case: the forward kernel against the plain forward (out, lse),
    then the dq and dkv kernels against the plain FA2 backward (dq, dk,
    dv), both backward versions fed the plain forward's out and lse so
    that each kernel is judged on its own; bf16 outputs also row by row
    (flash_row_err), and a second bf16 backward call must give the same
    bits (no atomics). Returns (errors, plain out, plain lse)."""
    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    dt = q.dtype
    out, lse = fa.flash_attention_fwd_cuda(q, k, v, causal, scale)
    want_out, want_lse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                          scale)
    grads = fa.flash_attention_bwd_cuda(q, k, v, want_out, want_lse, do,
                                        causal, scale)
    again = (fa.flash_attention_bwd_cuda(q, k, v, want_out, want_lse,
                                         do, causal, scale)
             if dt != torch.float32 else grads)
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
        check(got.shape == want.shape, f"flash {name}: {key} shape "
              f"{tuple(got.shape)} != {tuple(want.shape)}")
        err = float((got.float() - want.float()).abs().max())
        half_rel, grad_row_rel = ((FLASH_F16_REL, FLASH_F16_GRAD_ROW_REL)
                                  if dt == torch.float16 else
                                  (FLASH_BF16_REL, FLASH_GRAD_ROW_REL))
        tol = (FLASH_F32_ATOL if dt == torch.float32 else
               half_rel * float(want.float().abs().max()))
        errs[key] = err
        row_tol = half_rel if key == "out" else grad_row_rel
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
    return errs, want_out, want_lse


def phase_flash():
    """Each case of FLASH_CASES through :func:`flash_check`; the first
    (the training shape) is kept for the timings."""
    gen = torch.Generator(device="cuda").manual_seed(4321)
    results = {}
    for name, dt, b, sq, sk, h, kv, d, causal in FLASH_CASES:
        def rnd(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(dt)

        q, k, v = rnd(b, sq, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d)
        do = rnd(b, sq, h, d)
        scale = 1.0 / d ** 0.5
        errs, want_out, want_lse = flash_check(name, q, k, v, do, causal,
                                               scale)
        results[name] = errs
        if not results.get("main"):
            delta = (do.float() * want_out.float()).sum(-1).transpose(
                1, 2).contiguous()
            results["main"] = dict(q=q, k=k, v=v, do=do, out=want_out,
                                   lse=want_lse, delta=delta, causal=causal,
                                   scale=scale, name=name)
        del q, k, v, do, want_out, want_lse
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
    """Times on the main case (the training shape), by
    :func:`time_flash_case`. The plain backward and SDPA's backward
    compute dq, dk and dv together; the plain and library times of dq and
    dkv are those of the whole backward, which is also timed as the port
    runs it (delta, dq, dkv), with delta's share."""
    m = results.pop("main")
    t = time_flash_case(m["q"], m["k"], m["v"], m["do"], m["out"], m["lse"],
                        m["causal"], m["scale"])
    timing = {}
    for kernel, ms, plain, lib in (
            ("fwd", "fwd_ms", "plain_fwd_ms", "library_fwd_ms"),
            ("dq", "dq_kernel_ms", "plain_bwd_ms", "library_bwd_ms"),
            ("dkv", "dkv_kernel_ms", "plain_bwd_ms", "library_bwd_ms")):
        r = timing[kernel] = dict(
            ms=t[ms], plain_ms=t[plain], library_ms=t[lib],
            bound_ms=t[f"{kernel}_bound_ms"],
            bound_by=t[f"{kernel}_bound_by"])
        log(f"[time] flash {kernel} {m['name']} ms={r['ms']} plain_ms="
            f"{r['plain_ms']} library_ms={r['library_ms']} bound_ms="
            f"{r['bound_ms']} ({r['bound_by']}) bound_share="
            f"{r['bound_ms'] / r['ms']}")
    delta_ms = time_delta(m["do"], m["out"])
    log(f"[time] flash backward pair dq+dkv ms="
        f"{timing['dq']['ms'] + timing['dkv']['ms']} whole_backward_ms="
        f"{t['bwd_ms']} (delta, dq, dkv) delta_ms={delta_ms} delta_share="
        f"{delta_ms / t['bwd_ms']} sdpa_backward_ms={t['library_bwd_ms']} "
        f"(dq, dk, dv in one call)")
    del m
    torch.cuda.empty_cache()
    return timing


def time_flash_bwd_whole(m):
    """ms of ``flash_attention_bwd_cuda`` (delta = rowsum(dO O) in plain
    torch, then the dq and dkv kernels) and of its delta alone."""
    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    q, k, v, do, out = m["q"], m["k"], m["v"], m["do"], m["out"]
    whole = time_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, out, m["lse"], do, m["causal"], m["scale"]))
    return whole, time_delta(do, out)


def time_delta(do, out):
    """ms of the backward's delta = rowsum(dO O), in plain torch."""
    return time_ms(lambda: (do.float() * out.float()).sum(-1).transpose(
        1, 2).contiguous())


# -- phase 5b: K10, the weight-only int8 matmul -------------------------------

# Llama-2-7B's linear shapes (name, K, N): q/k/v/o, gate/up, down, the head
INT8_SHAPES = (("4096x4096", 4096, 4096), ("4096x11008", 4096, 11008),
               ("11008x4096", 11008, 4096), ("4096x32000", 4096, 32000))
# rows: a decode step of 1 and of 8 slots, 8 slots x 8 verify rows, a
# 128-token prefill chunk, a 512-token chunk
INT8_ROWS = (1, 8, 64, 128, 512)
# ragged rows beside them (shape name, rows, dtype), and the row tiles'
# edges at gate/up: 16 (the last 16-row tile), 17 (a 32-row tile of 17),
# 129 (a 128-row tile and one of 1 row)
INT8_RAGGED = (("4096x11008", 37, torch.bfloat16),
               ("11008x4096", 300, torch.bfloat16),
               ("4096x4096", 45, torch.float32),
               ("4096x11008", 16, torch.bfloat16),
               ("4096x11008", 17, torch.bfloat16),
               ("4096x11008", 129, torch.bfloat16))
# the main path's shape: a decode step of 8 slots through gate/up
INT8_MAIN = "4096x11008_m8_bfloat16"
# K10 against its plain version. bf16: both sides sum in f32 (in other
# orders), round the sum to bf16, multiply by the bf16 scale and round
# again: two bf16 ulps of the largest output, 2^-6 of it. f32: the order
# of up to 11008 products only, 1e-5 of the largest output
INT8_REL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5}
# weights of one Llama-2-7B decode step: 224 linears and the untied head
LLAMA7B_INT8_WEIGHTS = 32 * (4 * 4096 * 4096 + 3 * 4096 * 11008) \
    + 4096 * 32000


def k10_inputs(gen, k, n):
    """Seeded int8 weights ``[k, n]`` over the whole range and f32
    scales of a quantized Llama weight's order (absmax / 127)."""
    q = torch.randint(-127, 128, (k, n), device="cuda", generator=gen,
                      dtype=torch.int8)
    s = (0.02 + 0.01 * torch.rand(1, n, device="cuda", generator=gen)) / 127
    return q, s


def k10_check(name, x, q, s):
    """K10 against its plain version, called twice for equal bits.
    Returns (max_abs_err, a failure message or None)."""
    from paddle_tpu_torch.ops.hopper.int8_matmul import (int8_matmul_cuda,
                                                         int8_matmul_plain)

    out = int8_matmul_cuda(x, q, s)
    out2 = int8_matmul_cuda(x, q, s)
    want = int8_matmul_plain(x, q, s)
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    tol = INT8_REL[x.dtype] * scale
    ok = bool(torch.isfinite(out).all()) and err <= tol
    same = torch.equal(out, out2)
    log(f"[k10] {name} max_abs_err={err} tol={tol} ({INT8_REL[x.dtype]} of "
        f"the largest |out| {scale}) ok={ok} bitwise_equal={same}")
    if ok and same:
        return err, None
    return err, (f"K10 {name}: kernel disagrees with the plain version (ok="
                 f"{ok}, equal bits={same})")


def phase_k10(failures=None):
    """K10 at every shape of INT8_SHAPES x INT8_ROWS in bf16 and f32 and at
    INT8_RAGGED; an N that is not a multiple of 16 must raise. A failure
    ends the run or, given a ``failures`` list, is added to it. Returns
    {case: inputs and error} for the timings (bf16 only)."""
    # the plain bf16 product sums in f32 throughout, as the kernel does
    # (restored after the checks: the timings take the library defaults)
    matmul = torch.backends.cuda.matmul
    before = (matmul.allow_bf16_reduced_precision_reduction,
              matmul.allow_tf32)
    matmul.allow_bf16_reduced_precision_reduction = False
    matmul.allow_tf32 = False
    try:
        return _k10_cases(failures)
    finally:
        (matmul.allow_bf16_reduced_precision_reduction,
         matmul.allow_tf32) = before


def _k10_cases(failures):
    from paddle_tpu_torch.ops.hopper.int8_matmul import int8_matmul_cuda

    gen = torch.Generator(device="cuda").manual_seed(10)
    results = {}
    cases = [(sh, m, dt) for sh, _, _ in INT8_SHAPES for m in INT8_ROWS
             for dt in (torch.bfloat16, torch.float32)] + list(INT8_RAGGED)
    weights = {sh: k10_inputs(gen, k, n) for sh, k, n in INT8_SHAPES}
    dims = {sh: (k, n) for sh, k, n in INT8_SHAPES}
    for sh, m, dt in cases:
        q, s = weights[sh]
        x = torch.randn(m, dims[sh][0], device="cuda", generator=gen).to(dt)
        name = f"{sh}_m{m}_{str(dt).split('.')[-1]}"
        err, failure = k10_check(name, x, q, s)
        if failures is None:
            check(failure is None, failure)
        elif failure:
            failures.append(failure)
        results[name] = dict(x=x, q=q, s=s, max_err=err,
                             timed=dt == torch.bfloat16)
    q, s = k10_inputs(gen, 4096, 4104)
    try:
        int8_matmul_cuda(torch.randn(8, 4096, device="cuda",
                                     dtype=torch.bfloat16), q, s)
        raised = False
    except ValueError as e:
        raised = "N % 16" in str(e)
    log(f"[k10] N=4104 (not a multiple of 16) raises: {raised}")
    if failures is None:
        check(raised, "K10 took an N that is not a multiple of 16")
    elif not raised:
        failures.append("K10 took an N that is not a multiple of 16")
    return results


def time_k10(results):
    """Each timed case of K10 by CUDA events and by CUDA-graph replay,
    beside ``torch.matmul`` on the same weight in bf16 (the dense product
    that quantization replaces), the plain version and the bound (int8
    weights, activations, scales and output over the HBM rate, or the
    products at the bf16 tensor-core peak); and the host microseconds a
    call of the wrapper and of ``torch.matmul`` (least of 5 rounds of
    100). Returns {case: times}."""
    from paddle_tpu_torch.ops.hopper.int8_matmul import (int8_matmul_cuda,
                                                         int8_matmul_plain)

    times = {}
    for name, r in results.items():
        if not r["timed"]:
            continue
        x, q, s = r["x"], r["q"], r["s"]
        (m, k), n = x.shape, q.shape[1]
        dense = q.to(torch.bfloat16)
        nbytes = k * n + 2 * m * k + 4 * n + 2 * m * n
        bound, by = _bound(nbytes, {torch.bfloat16: 2 * m * n * k})
        t = dict(
            ms=time_ms(lambda: int8_matmul_cuda(x, q, s)),
            graph_ms=time_ms_graph(lambda: int8_matmul_cuda(x, q, s)),
            host_us=host_us(lambda: int8_matmul_cuda(x, q, s))[0],
            library_host_us=host_us(lambda: torch.matmul(x, dense))[0],
            plain_ms=time_ms(lambda: int8_matmul_plain(x, q, s)),
            library_ms=time_ms(lambda: torch.matmul(x, dense)),
            library_graph_ms=time_ms_graph(lambda: torch.matmul(x, dense)),
            bound_ms=bound, bound_by=by, max_err=r["max_err"])
        del dense
        times[name] = t
        log(f"[k10-time] {name} "
            + " ".join(f"{key}={val}" for key, val in t.items())
            + f" graph_over_bound={t['graph_ms'] / bound} graph_over_"
            f"library={t['graph_ms'] / t['library_graph_ms']}")
    return times


def k10_host_parts(results):
    """Host microseconds of each part of a K10 call at INT8_MAIN (the
    least of 5 rounds of 100 back-to-back calls, enqueue only): the
    checks, the output's allocation (and the ``torch.empty`` it
    replaced), the plan lookup, the stream lookup, the launch count's
    lock, the library call without a launch (M = 0: ctypes and the
    argument checks) and with it (the current device, q's cached tensor
    map, x's map, the launch), the whole wrapper, and ``torch.matmul``
    on the weight in bf16."""
    from paddle_tpu_torch.ops.hopper import int8_matmul as hop

    r = results[INT8_MAIN]
    x, q, s = r["x"], r["q"], r["s"]
    (m, k), n = x.shape, q.shape[1]
    dev = x.get_device()
    out = hop.int8_matmul_cuda(x, q, s)
    code = hop.int8_matmul_plan(m, n, k, x.dtype, hop._sms(dev))["code"]
    lib = hop._library()
    dense = q.to(torch.bfloat16)
    tally = types.SimpleNamespace(launches=0)

    def call(rows):
        return lib.int8_matmul_launch(
            x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), rows,
            n, k, code, dev, torch._C._cuda_getCurrentRawStream(dev))

    parts = {
        "check": lambda: hop._check(x, q, s),
        "new_empty": lambda: x.new_empty((m, n)),
        "torch.empty": lambda: torch.empty((m, n), device=x.device,
                                           dtype=x.dtype),
        "plan": lambda: hop.int8_matmul_plan(m, n, k, x.dtype,
                                             hop._sms(dev))["code"],
        "stream": lambda: torch._C._cuda_getCurrentRawStream(dev),
        "count_launch": lambda: hop.count_launch(tally),
        "library_call_no_launch": lambda: call(0),
        "library_call": lambda: call(m),
        "wrapper": lambda: hop.int8_matmul_cuda(x, q, s),
        "torch.matmul": lambda: torch.matmul(x, dense),
    }
    us = {name: host_us(fn)[0] for name, fn in parts.items()}
    log(f"[k10-host] {INT8_MAIN} parts_us_per_call={json.dumps(us)} "
        f"wrapper_over_matmul={us['wrapper'] / us['torch.matmul']}")


def k10_sweep(results):
    """Each timed case of INT8_ROWS through every split of K the C call
    takes for its row tile (1, 2, 4 or 8 CTAs): checked against the
    plain version (equal bits twice), timed by graph replay. The plan's
    launch is marked."""
    from paddle_tpu_torch.ops.hopper import int8_matmul as hop

    lib = hop._library()
    for name, r in results.items():
        x, q, s = r["x"], r["q"], r["s"]
        (m, k), n = x.shape, q.shape[1]
        if not r["timed"] or m not in INT8_ROWS:
            continue
        dev = x.get_device()
        plan = hop.int8_matmul_plan(m, n, k, x.dtype, hop._sms(dev))
        want = hop.int8_matmul_plain(x, q, s).float()
        tol = INT8_REL[x.dtype] * float(want.abs().max())
        for splits in (1, 2, 4, 8):
            per = -(-plan["stages"] // splits)
            if -(-plan["stages"] // per) != splits:
                continue
            code = hop.plan_code(per, splits, plan["bm"], 1)

            def call(out, _code=code):
                rc = lib.int8_matmul_launch(
                    x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                    m, n, k, _code, dev,
                    torch._C._cuda_getCurrentRawStream(dev))
                check(rc == 0, f"K10 sweep {name}: CUDA error {rc}")
                return out

            got, again = call(x.new_empty((m, n))), call(x.new_empty((m, n)))
            torch.cuda.synchronize()
            err = float((got.float() - want).abs().max())
            check(err <= tol and torch.equal(got, again),
                  f"K10 sweep {name} splits={splits}: max_abs_err={err} "
                  f"tol={tol}")
            buf = x.new_empty((m, n))
            log(f"[k10-sweep] {name} bm={plan['bm']} wg={plan['wg']} "
                f"splits={splits} graph_ms={time_ms_graph(lambda: call(buf))}"
                f" max_abs_err={err}"
                + (" (the plan's launch)" if code == plan["code"] else ""))


def k10_kernel_loop():
    """Build K10 alone (ptxas registers, spills, shared memory), check it
    at every case of phase 5b and time it; where the wrapper has them,
    the host microseconds by part and every launch the C call takes.
    Every case runs; the failures are reported together at the end.
    Works on another checkout's port too (``--root``)."""
    from paddle_tpu_torch.ops.hopper import int8_matmul

    phase_device()
    log(f"[k10] implementation={os.path.dirname(int8_matmul.__file__)}")
    build_log(int8_matmul.build)
    failures = []
    results = phase_k10(failures)
    time_k10(results)
    if hasattr(int8_matmul, "plan_code"):
        k10_host_parts(results)
        k10_sweep(results)
    log(f"[k10] failures={failures}")
    check(not failures, f"K10: {failures}")


def k10_only():
    """``--int8``: :func:`k10_kernel_loop`, then build K5 and K6 and run
    phase 6's int8 gate at Llama-2-7B width (2 layers, f32) and phase 7h
    on full Llama-2-7B. ``--int8-kernel`` stops after the kernel loop.
    Both work on another checkout's port too (``--root``). Prints no
    result line."""
    from paddle_tpu_torch import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.hopper import paged_attention, rms_norm

    k10_kernel_loop()
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(lambda b: b(), (paged_attention.build,
                                      rms_norm.build)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = LlamaForCausalLM(LlamaConfig.llama2_7b(num_hidden_layers=2,
                                                   dtype="float32"), seed=0)
    phase_parity_int8(model, phase6_prompts(model.config.vocab_size))
    del model
    release_device_memory()
    _, _, card = phase_device()
    model = LlamaForCausalLM(LlamaConfig.llama2_7b(dtype="bfloat16"), seed=0)
    knobs = dict(block_size=16, max_slots=8, prefill_chunk=128)
    warm_serving(model, knobs)
    phase_int8_serving(model, knobs, card)
    return 0


# -- phase 6: parity at full width --------------------------------------------

def serving_geometry(model):
    """(layers, K/V heads, head_dim) of a Llama (``model.config``) or a
    GPT (``model.gpt.cfg``, K/V at every head), as the engine reads
    them."""
    cfg = getattr(model, "config", None) or model.gpt.cfg
    kv = getattr(cfg, "num_key_value_heads", cfg.num_attention_heads)
    return (cfg.num_hidden_layers, kv,
            cfg.hidden_size // cfg.num_attention_heads)


def _dense_last_logits(model, tokens):
    """Dense-cache forward of ``tokens`` in one prefill: last-row f32
    logits (for the top-2 gap of a mismatch report)."""
    layers, kv, d = serving_geometry(model)
    dev = next(model.parameters()).device
    caches = [(torch.zeros(1, len(tokens), kv, d, device=dev),
               torch.zeros(1, len(tokens), kv, d, device=dev))
              for _ in range(layers)]
    with torch.no_grad():
        logits, _ = model(torch.tensor([tokens], device=dev),
                          kv_caches=caches, position_offset=0)
    return logits[0, -1].float()


def _check_greedy(model, label, prompts, got, n_new):
    """Each request's engine tokens against dense greedy ``generate``;
    on a mismatch, log the first differing step and the dense path's
    top-2 logit gap there, and fail."""
    dev = next(model.parameters()).device
    for i, (p, toks) in enumerate(zip(prompts, got)):
        want = model.generate(torch.tensor([p], device=dev),
                              max_new_tokens=n_new)[0, len(p):].tolist()
        if toks != want:
            step = next(j for j, (a, b) in enumerate(zip(toks, want))
                        if a != b)
            top2 = torch.topk(_dense_last_logits(model, p + want[:step]), 2)
            gap = float(top2.values[0] - top2.values[1])
            log(f"[parity] MISMATCH {label} request {i} at step {step}: "
                f"engine {toks} dense {want} top-2 logit gap {gap}")
            raise SmokeFailure(f"{label}: engine and dense greedy tokens "
                               f"differ")
        log(f"[parity] {label} request {i} prompt_len={len(p)} "
            f"tokens={toks} equal=True")


def _engine_outputs(engine, prompts, n_new):
    rids = [engine.add_request(p, max_new_tokens=n_new) for p in prompts]
    done = engine.run()
    engine.pool.check_invariants()
    return [done[r].output_ids for r in rids]


def repeat_heavy_prompts(rng, vocab, n_req, pat_len, reps, jitter):
    """bench.py's repeat-heavy mix (``_repeat_heavy_prompts``): a random
    pattern tiled ``reps`` times plus up to ``jitter`` more tokens."""
    prompts = []
    for _ in range(n_req):
        pat = rng.integers(0, vocab, pat_len).tolist()
        n = pat_len * reps + int(rng.integers(0, jitter + 1))
        prompts.append((pat * (reps + 1))[:n])
    return prompts


def tinyllama_config(**kw):
    """The draft model's geometry: TinyLlama-1.1B's published config
    (Llama-2's 32000-token vocabulary, hidden 2048, intermediate 5632,
    22 layers, 32 heads over 4 KV heads, head_dim 64)."""
    from paddle_tpu_torch import LlamaConfig

    base = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5632,
                num_hidden_layers=22, num_attention_heads=32,
                num_key_value_heads=4, max_position_embeddings=2048)
    base.update(kw)
    return LlamaConfig(**base)


def phase_parity():
    """Phase 6: engine greedy tokens equal dense ``generate`` at
    Llama-2-7B width, 2 layers, f32: the default engine (prefix cache
    on); a shared-prefix set with caching on and off; a repeat-heavy set
    under n-gram and draft-model speculation; the host tier and the
    fault points; telemetry and the handoff; the fleet."""
    from paddle_tpu_torch import LlamaConfig, LlamaForCausalLM, ServingEngine

    # f32 products run in full f32, not TF32, on both paths
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, dtype="float32")
    model = LlamaForCausalLM(cfg, seed=0)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 17, 29, 40)]
    check(prompts == phase6_prompts(cfg.vocab_size), "phase 6's prompts")
    engine = ServingEngine.from_model(model)
    check(engine.pool.prefix_cache, "the engine's default has no prefix "
          "cache")
    default_out = _engine_outputs(engine, prompts, 8)
    _check_greedy(model, "default", prompts, default_out, 8)
    log(f"[parity] llama2_7b width, 2 layers, f32: {len(prompts)} requests "
        f"equal (engine dispatches={engine.dispatches})")
    del engine
    phase_parity_telemetry(model, prompts, default_out)
    # four prompts on one 40-token prefix; the first (48 tokens, three
    # whole blocks) is resubmitted right after itself, so the copy's
    # capped hit (47 tokens) ends inside a block the original holds
    prefix = rng.integers(0, cfg.vocab_size, 40).tolist()
    shared = [prefix + rng.integers(0, cfg.vocab_size, n).tolist()
              for n in (8, 3, 11, 21)]
    shared.insert(1, list(shared[0]))
    for cache in (True, False):
        engine = ServingEngine.from_model(model, prefix_cache=cache)
        _check_greedy(model, f"shared_prefix cache={cache}", shared,
                      _engine_outputs(engine, shared, 8), 8)
        m = engine.metrics.snapshot()
        log(f"[parity] shared_prefix cache={cache}: prefix_hits="
            f"{m['prefix_hits']} hit_tokens={m['prefix_hit_tokens']} "
            f"cow_copies={m['cow_copies']} tokens_computed="
            f"{m['tokens_computed']}")
        if cache:
            check(m["prefix_hits"] > 0 and m["cow_copies"] > 0,
                  "shared-prefix set: no prefix hit or no copy-on-write")
    draft = LlamaForCausalLM(tinyllama_config(num_hidden_layers=2,
                                              dtype="float32"), seed=1)
    rep = repeat_heavy_prompts(rng, cfg.vocab_size, 6, 16, 3, 8)
    for mode in ("ngram", "draft"):
        engine = ServingEngine.from_model(
            model, spec=mode, draft_model=draft if mode == "draft" else None)
        _check_greedy(model, f"spec={mode}", rep,
                      _engine_outputs(engine, rep, 24), 24)
        m = engine.metrics.snapshot()
        log(f"[parity] spec={mode}: proposed={m['spec_proposed']} "
            f"accepted={m['spec_accepted']} verify_dispatches="
            f"{engine.verify_dispatches}")
        check(engine.verify_dispatches > 0, f"spec={mode}: no verify row "
              f"was dispatched")
    del engine, draft
    release_device_memory()
    phase_parity_tier(model)
    phase_parity_fleet(model, prompts)
    phase_parity_int8(model, prompts)   # quantizes the model: its last use
    log(f"[parity] seconds={time.perf_counter() - t0}")
    del model
    release_device_memory()
    check_released("phase 6", base)


def phase6_prompts(vocab):
    """Phase 6's default-engine prompts: 4 seeded prompts of 5-40
    tokens (the first draws of phase 6's generator)."""
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, n).tolist() for n in (5, 17, 29, 40)]


def linear_weights(model):
    """(elements, bytes) of the 2-D weights ``quantize_for_decode``
    converts: every Column/RowParallelLinear and an untied LM head."""
    from paddle_tpu_torch.distributed.fleet.mpu import (ColumnParallelLinear,
                                                        RowParallelLinear)
    from paddle_tpu_torch.models.llama import LlamaLMHead

    n = nbytes = 0
    for m in model.modules():
        if isinstance(m, (ColumnParallelLinear, RowParallelLinear)) or (
                isinstance(m, LlamaLMHead) and not m._tied):
            n += m.weight.numel()
            nbytes += m.weight.numel() * m.weight.element_size()
    return n, nbytes


def phase_parity_int8(model, prompts):
    """Phase 6's int8 gate (f32, TF32 off) on phase 6's model, which it
    quantizes in place: ``quantize_for_decode`` on the card gives the
    same int8 bytes and scales as on the CPU (a copy of the same weights);
    linear weight memory is a quarter of f32's (half of bf16's) and the
    card frees the difference; the engine's greedy tokens (K5, K6, K10,
    15 K10 launches a dispatch at 2 layers) equal dense ``generate``'s on
    the same quantized model."""
    import copy

    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.models.generation import quantize_for_decode
    from paddle_tpu_torch.ops.hopper.int8_matmul import int8_matmul_cuda

    t0 = time.perf_counter()
    cfg = model.config
    n_lin, f32_bytes = linear_weights(model)
    host = copy.deepcopy(model).to("cpu")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    quantize_for_decode(model)
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated()
    quantize_for_decode(host)
    card_state, host_state = model.state_dict(), host.state_dict()
    n_int8 = n_scales = 0
    for name, t in card_state.items():
        if t.dtype == torch.int8 or name.endswith(".weight_scale"):
            check(torch.equal(t.cpu(), host_state[name]),
                  f"int8 gate: {name} differs between the card's and the "
                  f"CPU's quantize_for_decode")
            n_int8 += t.dtype == torch.int8
            n_scales += name.endswith(".weight_scale")
    want_n = 7 * cfg.num_hidden_layers + 1
    check(n_int8 == want_n == n_scales, f"int8 gate: {n_int8} int8 weights "
          f"and {n_scales} scales, want {want_n} of each")
    _, int8_bytes = linear_weights(model)
    scale_bytes = sum(t.numel() * 4 for n, t in card_state.items()
                      if n.endswith(".weight_scale"))
    log(f"[parity-int8] int8 bytes and scales equal card vs CPU: {n_int8} "
        f"weights; linear weight bytes f32 {f32_bytes} bf16 {2 * n_lin} "
        f"int8 {int8_bytes} (x{f32_bytes / int8_bytes} f32, "
        f"x{2 * n_lin / int8_bytes} bf16); card memory freed {freed} "
        f"(f32 - int8 - scales = {f32_bytes - int8_bytes - scale_bytes})")
    check(4 * int8_bytes == f32_bytes and int8_bytes == n_lin,
          "int8 gate: linear weights are not a quarter of f32's")
    check(abs(freed - (f32_bytes - int8_bytes - scale_bytes)) < 1 << 22,
          f"int8 gate: the card freed {freed} bytes, not the f32 weights' "
          f"difference")
    del host, host_state
    engine = ServingEngine.from_model(model)
    int8_matmul_cuda.launches = 0
    out = _engine_outputs(engine, prompts, 8)
    k10 = int8_matmul_cuda.launches
    check(k10 == want_n * engine.dispatches, f"int8 gate: K10 launches {k10}"
          f" != {want_n} x {engine.dispatches} dispatches")
    _check_greedy(model, "int8", prompts, out, 8)
    log(f"[parity-int8] llama2_7b width, {cfg.num_hidden_layers} layers, f32:"
        f" engine tokens equal dense generate on the quantized model; K10 "
        f"launches {k10} = {want_n} x {engine.dispatches} dispatches; "
        f"seconds={time.perf_counter() - t0}")
    del engine
    release_device_memory()


def _moved_blocks_equal(dst, rid, state):
    """The destination pool's blocks of an imported request, exported
    again, against the source's manifest: byte-equal, layer by layer."""
    back = dst.pool.export_seq(rid, state["ctx"])
    return all(torch.equal(a, b) for part in ("k", "v")
               for a, b in zip(state["kv"][part], back[part]))


def phase_parity_telemetry(model, prompts, off_outputs):
    """Phase 6, telemetry and the request handoff (f32, 2 layers at
    Llama-2-7B width). The default engine with ``FLAGS_telemetry`` on
    gives the telemetry-off tokens (which equal dense greedy), one
    ``serving/engine_step`` span a step and one timeline a request. Then
    two requests move from one engine to a second on the same model: one
    after 4 decode tokens, one in mid-prefill (a 200-token prompt, two
    chunks of 128); their tokens equal the unmoved run, and the second
    pool's imported blocks are byte-equal to the exported manifest."""
    from paddle_tpu_torch import ServingEngine, telemetry

    with port_flags(telemetry=True):
        telemetry.reset_all()
        engine = ServingEngine.from_model(model)
        on = _engine_outputs(engine, prompts, 8)
        steps = engine.metrics.steps
        spans = sum(s["name"] == "serving/engine_step"
                    for s in telemetry.snapshot_spans())
        timelines = telemetry.snapshot_requests()
        log(f"[parity] telemetry on: tokens equal off={on == off_outputs} "
            f"steps={steps} engine_step_spans={spans} "
            f"timelines={len(timelines)} ledger={engine.metrics.ledger}")
        check(on == off_outputs, f"telemetry on: tokens differ from the "
              f"telemetry-off run at {first_divergence(on, off_outputs)}")
        check(spans == steps and len(timelines) == len(prompts),
              "telemetry on: spans or timelines do not match the run")
        del engine

        long_prompt = np.random.default_rng(9).integers(
            0, model.config.vocab_size, 200).tolist()
        reqs = [prompts[1], long_prompt]
        unmoved = _engine_outputs(ServingEngine.from_model(model), reqs, 8)
        src = ServingEngine.from_model(model)
        dst = ServingEngine.from_model(model)
        rids = [src.add_request(p, max_new_tokens=8) for p in reqs]
        moved, where = {}, {}

        def move(rid, at):
            state = src.export_request(rid)
            new = dst.import_request(state)
            check(_moved_blocks_equal(dst, new, state),
                  f"handoff {at}: imported blocks differ from the manifest")
            src.release_handoff(rid, dest=1)
            moved[rid], where[rid] = new, (at, state["ctx"],
                                           state["kv"]["nbytes"])

        while len(moved) < 2:
            check(src.has_work(), "handoff: the source ran out of work")
            src.step()
            if (rids[1] not in moved and rids[1] in src.migrate_ready()
                    and src.requests[rids[1]].state == "prefill"):
                move(rids[1], "mid-prefill")
            if (rids[0] not in moved and rids[0] in src.handoff_ready()
                    and len(src.requests[rids[0]].output) == 4):
                move(rids[0], "mid-decode")
        check(not src.has_work() and pool_clean(src),
              "handoff: the source still holds work or blocks")
        done = dst.run()
        got = [done[moved[r]].output_ids for r in rids]
        log(f"[parity] handoff (where, ctx, manifest bytes)="
            f"{[where[r] for r in rids]} tokens equal unmoved="
            f"{got == unmoved} source ledger={src.metrics.ledger} "
            f"destination handoffs={dst.health()['handoffs']}")
        check(got == unmoved, f"handoff: moved tokens differ from the "
              f"unmoved run at {first_divergence(got, unmoved)}")
        check(all(done[moved[r]].outcome == "ok" for r in rids),
              "handoff: a moved request did not finish ok")
        check(src.metrics.ledger == {"goodput": src.metrics.tokens_computed},
              f"handoff: source ledger {src.metrics.ledger}")
        check(pool_clean(dst), "handoff: the destination pool is not clean")
        telemetry.reset_all()


@contextlib.contextmanager
def port_flags(**kw):
    """The port's FLAGS_* set for the block and restored after it; fault
    rules are re-armed with zeroed counters."""
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.distributed import fault

    old = flags.get_flags(list(kw))
    flags.set_flags(kw)
    fault.reset()
    try:
        yield
    finally:
        flags.set_flags(old)
        fault.reset()


def closed_loop(engine, prompts, max_new):
    """bench.py's sequential replay: each request runs to its end before
    the next arrives. Returns the finished Sequences in order."""
    seqs = []
    for p in prompts:
        rid = engine.add_request(p, max_new_tokens=max_new)
        seqs.append(engine.run()[rid])
    return seqs


def pool_clean(engine):
    """Invariants hold and no request holds a block: every usable block
    is free or cached."""
    pool = engine.pool
    pool.check_invariants()
    return (not engine.requests
            and pool.num_free + pool.num_cached == pool.num_usable)


def hosttier_setup(mode, prompts, max_new, starved, block_size):
    """(engine arguments, port flags) of one of bench.py's zipf-hosttier
    runs (bench.py:897-1000): ``device``, an unbounded cached set and a
    pool that holds every request's blocks at once (nothing is ever
    evicted); ``host``, the cached set starved to ``starved`` blocks and
    the host tier on; ``cold``, the same starved set, tier off."""
    if mode == "device":
        blocks = 1 + sum(-(-(len(p) + max_new) // block_size) + 1
                         for p in prompts)
        return (dict(prefix_cache=True, host_tier=False, pool_blocks=blocks),
                dict(serving_prefix_cached_blocks=0))
    return (dict(prefix_cache=True, host_tier=mode == "host"),
            dict(serving_prefix_cached_blocks=starved))


def phase_parity_tier(model):
    """Phase 6, the host tier and the fault points (f32, 2 layers):
    bench.py's zipf-hosttier mix reduced (12 requests, 3 system prompts
    of 64 tokens, suffixes of 1-8, 8 new tokens, a cached set of 4 blocks
    of 16) in its three runs: greedy tokens equal dense ``generate`` in
    all three, ``host`` computes as many tokens as ``device`` and
    ``cold`` more. Then the host run under ``serving.decode:times=1`` and
    under ``serving.host_tier.restore:times=1``: the fault-free tokens,
    every outcome ok, the retries the JAX package charges (one replay of
    the request whose decode failed; none for a restore fault, which
    falls back to a cold prefill) and a clean pool."""
    from paddle_tpu_torch import ServingEngine

    prompts = zipf_prompts(np.random.RandomState(7), model.config.vocab_size,
                           12, 3, 64, 8)
    check(3 * (64 // 16) > 4, "the hot prefixes must oversubscribe the "
          "cached set")
    out, computed = {}, {}
    for mode in ("device", "host", "cold"):
        kw, fl = hosttier_setup(mode, prompts, 8, 4, 16)
        with port_flags(**fl):
            engine = ServingEngine.from_model(model, block_size=16, **kw)
            out[mode] = [s.output_ids for s in closed_loop(engine, prompts,
                                                           8)]
        check(pool_clean(engine), f"hosttier {mode}: the pool is not clean")
        m = engine.metrics.snapshot()
        computed[mode] = m["tokens_computed"]
        log(f"[parity] hosttier {mode}: tokens_computed="
            f"{m['tokens_computed']} prefix_hit_tokens="
            f"{m['prefix_hit_tokens']} host_hits={m['host_tier_hits']} "
            f"host_hit_tokens={m['host_tier_hit_tokens']} spills="
            f"{m['host_tier_spills']}")
        if mode == "host":
            check(m["host_tier_hits"] > 0 and m["host_tier_spills"] > 0,
                  "hosttier host: no spill or no host hit")
    _check_greedy(model, "hosttier device", prompts, out["device"], 8)
    check(out["host"] == out["device"] and out["cold"] == out["device"],
          "hosttier: host or cold tokens differ from device tokens")
    check(computed["host"] == computed["device"] < computed["cold"],
          f"hosttier: tokens computed {computed} (want host == device < "
          f"cold)")
    kw, fl = hosttier_setup("host", prompts, 8, 4, 16)
    for spec in ("serving.decode:times=1",
                 "serving.host_tier.restore:times=1"):
        with port_flags(fault_spec=spec, **fl):
            engine = ServingEngine.from_model(model, block_size=16, **kw)
            seqs = closed_loop(engine, prompts, 8)
        retries = [s.retries for s in seqs]
        m = engine.metrics.snapshot()
        log(f"[parity] hosttier host {spec}: retries={retries} "
            f"step_failures={m['step_failures']} restore_failures="
            f"{engine.pool.host_restore_failures} outcomes="
            f"{m['terminal_reasons']}")
        check([s.output_ids for s in seqs] == out["host"],
              f"{spec}: tokens differ from the fault-free run")
        check(all(s.outcome == "ok" for s in seqs), f"{spec}: an outcome "
              f"other than ok")
        if "decode" in spec:
            check(retries == [1] + [0] * 11
                  and m["step_failures"] == {"decode": 1},
                  f"{spec}: retries {retries}")
        else:
            check(retries == [0] * 12 and m["step_failures"] == {}
                  and engine.pool.host_restore_failures == 1,
                  f"{spec}: retries {retries}, restore failures "
                  f"{engine.pool.host_restore_failures}")
        check(pool_clean(engine), f"{spec}: the pool is not clean")


# -- phase 7: full Llama-2-7B serving -----------------------------------------

def zipf_prompts(rng, vocab, n_req, n_prefixes, prefix_len, suffix_max,
                 alpha=1.2, with_prefixes=False):
    """bench.py's shared-prefix mix (``_zipf_prompts``), draw for draw:
    ``n_prefixes`` system prompts, each request picks one by Zipf(alpha)
    popularity and appends a unique suffix of 1..suffix_max tokens. With
    ``with_prefixes``, returns (prompts, system prompts)."""
    prefixes = [rng.randint(0, vocab, (prefix_len,)).tolist()
                for _ in range(n_prefixes)]
    probs = np.arange(1, n_prefixes + 1, dtype=np.float64) ** -float(alpha)
    probs /= probs.sum()
    prompts = []
    for _ in range(n_req):
        k = int(rng.choice(n_prefixes, p=probs))
        n_suf = int(rng.randint(1, suffix_max + 1))
        prompts.append(prefixes[k] + rng.randint(0, vocab, (n_suf,)).tolist())
    return (prompts, prefixes) if with_prefixes else prompts


def shared_prefix_mix(vocab):
    """Phase 7a's requests: bench.py's ``serve_prefix`` mix at its chip
    sizes (32 requests, 4 system prompts of 192 tokens, Zipf 1.2, suffixes
    of 1-32 tokens, RandomState(0)) plus 4 exact resubmits: the first
    prompt whose length is whole blocks of 16 right after itself (its
    capped hit ends inside a block the original still holds: a
    copy-on-write), and the first three prompts at the end (their blocks
    are cached by then)."""
    prompts = zipf_prompts(np.random.RandomState(0), vocab, 32, 4, 192, 32)
    whole = next(i for i, p in enumerate(prompts) if len(p) % 16 == 0)
    prompts.insert(whole + 1, list(prompts[whole]))
    return prompts + [list(p) for p in prompts[:3]]


def first_divergence(a, b):
    """Per request, the index of the first output token where two runs
    differ, -1 where they are equal."""
    return [next((i for i, (x, y) in enumerate(zip(p, q)) if x != y), -1)
            for p, q in zip(a, b)]


def serve_run(engine, label, prompts, max_new, closed_loop=False,
              k10_per_dispatch=0, layers=LLAMA_LAYERS, rms_norms=True):
    """One burst of requests (every arrival at t0) through ``engine``,
    or with ``closed_loop`` bench.py's sequential replay (each request
    arrives when the one before it finished): every dispatch's logits
    checked finite, K5/K6/K10 launches counted over this run alone and
    held to 32 x target dispatches + 22 x draft dispatches (K5), 65 x
    target + 45 x draft (K6) and ``k10_per_dispatch`` x target (K10: 225
    for a quantized Llama-2-7B, else 0), each request held to ``max_new``
    tokens and outcome ok, and the pool to its invariants. A target of
    another depth gives its ``layers``; one without RMSNorm (GPT) runs
    K6 no time. Logs the run's numbers and returns them."""
    from paddle_tpu_torch.ops.hopper.int8_matmul import int8_matmul_cuda
    from paddle_tpu_torch.ops.hopper.paged_attention import paged_attend_cuda
    from paddle_tpu_torch.ops.hopper.rms_norm import rms_norm_cuda
    from paddle_tpu_torch.serving.robustness import now_s

    finite = []
    for name in ("_dispatch", "_dispatch_full"):
        def checked(*args, _fn=getattr(engine, name)):
            out = _fn(*args)
            finite.append(bool(np.isfinite(out).all()))
            return out
        setattr(engine, name, checked)
    draft = getattr(engine._proposer, "model", None)
    draft_layers = 0 if draft is None else draft.config.num_hidden_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    d0 = engine.dispatches
    dd0 = getattr(engine._proposer, "dispatches", 0)
    paged_attend_cuda.launches = 0
    rms_norm_cuda.launches = 0
    int8_matmul_cuda.launches = 0
    t0 = time.perf_counter()
    if closed_loop:
        rids, done = [], {}
        for p in prompts:
            rids.append(engine.add_request(p, max_new_tokens=max_new))
            done.update(engine.run())
    else:
        t_arrival = now_s()
        rids = [engine.add_request(p, max_new_tokens=max_new,
                                   arrival_s=t_arrival) for p in prompts]
        t0 = time.perf_counter()
        done = engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5, k6 = paged_attend_cuda.launches, rms_norm_cuda.launches
    k10 = int8_matmul_cuda.launches
    del engine._dispatch, engine._dispatch_full   # the wrappers' cycles
    n_target = engine.dispatches - d0
    n_draft = getattr(engine._proposer, "dispatches", 0) - dd0
    m = engine.metrics.snapshot()
    out_tokens = sum(len(done[r].output) for r in rids)
    r = dict(label=label, wall_s=wall, output_tok_s=out_tokens / wall,
             steps=m["steps"], dispatches=n_target,
             verify_dispatches=engine.verify_dispatches,
             draft_dispatches=n_draft, k5=k5, k6=k6, k10=k10,
             peak_memory_bytes=torch.cuda.max_memory_allocated(),
             outputs=[done[i].output_ids for i in rids],
             **{k: m[k] for k in (
                 "ttft_p50_s", "ttft_p95_s", "tpot_p50_s", "tpot_p95_s",
                 "tokens_computed", "prefix_hits", "prefix_hit_tokens",
                 "prefix_hit_rate", "cow_copies", "preemptions",
                 "spec_proposed", "spec_accepted", "spec_accept_rate",
                 "spec_tokens_per_step_p50", "spec_tokens_per_step_p95",
                 "host_tier_hits", "host_tier_hit_tokens",
                 "host_tier_spills", "host_tier_evictions",
                 "host_tier_restore_failures", "host_tier_blocks",
                 "host_tier_bytes", "terminal_reasons")})
    log(f"[serve:{label}] requests={len(prompts)} max_new={max_new} "
        + " ".join(f"{k}={v}" for k, v in r.items()
                   if k not in ("label", "outputs")))
    check(sorted(done) == sorted(rids), f"{label}: not every request "
          f"finished")
    check(all(len(done[i].output) == max_new for i in rids),
          f"{label}: a request finished with other than {max_new} tokens")
    check(all(done[i].outcome == "ok" for i in rids),
          f"{label}: a request finished with another outcome than ok")
    check(finite and all(finite), f"{label}: non-finite logits")
    check(k5 == layers * n_target + draft_layers * n_draft,
          f"{label}: K5 launches {k5} != {layers} x {n_target} + "
          f"{draft_layers} x {n_draft}")
    k6_target = 2 * layers + 1 if rms_norms else 0
    check(k6 == k6_target * n_target + (2 * draft_layers + 1) * n_draft,
          f"{label}: K6 launches {k6} != {k6_target} x {n_target} + "
          f"{2 * draft_layers + 1} x {n_draft}")
    check(k10 == k10_per_dispatch * n_target, f"{label}: K10 launches {k10} "
          f"!= {k10_per_dispatch} x {n_target}")
    engine.pool.check_invariants()
    return r


def phase_serving(card):
    """Phase 7: full Llama-2-7B in bf16 through the engine (block 16, 8
    slots, prefill chunk 128): the main run and its profile window, then
    the shared-prefix mix with caching on and off (7a), the repeat-heavy
    mix with n-gram speculation and without (7b), a short run with a
    TinyLlama-geometry draft model (7c), the host tier (7d), the
    robustness contract (7e) and telemetry with the handoff (7f).
    Returns each run's numbers."""
    from paddle_tpu_torch import LlamaConfig, LlamaForCausalLM, ServingEngine

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    cfg = LlamaConfig.llama2_7b(dtype="bfloat16")
    check(cfg.num_hidden_layers == LLAMA_LAYERS, "expected 32 layers")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, seed=0)
    knobs = dict(block_size=16, max_slots=8, prefill_chunk=128)
    warm_serving(model, knobs)
    engine = ServingEngine.from_model(model, **knobs)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    log(f"[serve] model+pool setup seconds={time.perf_counter() - t0} "
        f"pool_blocks={engine.pool.num_blocks} weight_bytes={weight_bytes}")
    prompts = phase7_mix(cfg.vocab_size)
    runs = {"main": serve_run(engine, "main", prompts, 64)}
    log(f"[serve] prompts={[len(p) for p in prompts]} phase_seconds="
        f"{json.dumps(engine.metrics.snapshot()['phase_seconds'])}")
    profile_window(engine, cfg.vocab_size)
    del engine
    release_device_memory()

    t0 = time.perf_counter()
    shared = shared_prefix_mix(cfg.vocab_size)
    for cache in (True, False):
        engine = ServingEngine.from_model(model, prefix_cache=cache, **knobs)
        label = f"prefix_cache_{'on' if cache else 'off'}"
        runs[label] = serve_run(engine, label, shared, PHASE7_CUT_NEW)
        del engine
        release_device_memory()
    on = runs["prefix_cache_on"]
    check(on["prefix_hits"] > 0 and on["cow_copies"] > 0,
          "7a: no prefix hit or no copy-on-write with caching on")
    log(f"[serve:7a] seconds={time.perf_counter() - t0} first differing "
        f"output token, caching on against off, per request (-1: equal): "
        f"{first_divergence(on['outputs'], runs['prefix_cache_off']['outputs'])}"
        f" (bf16: a cached prefix was computed in other chunks, so a near "
        f"tie may round apart; phase 6 holds the f32 tokens equal)")

    t0 = time.perf_counter()
    rep = repeat_heavy_prompts(np.random.default_rng(0), cfg.vocab_size,
                               32, 16, 8, 16)
    for spec in ("ngram", "off"):
        engine = ServingEngine.from_model(model, spec=spec,
                                          token_budget=512, **knobs)
        runs[f"spec_{spec}"] = serve_run(engine, f"spec_{spec}", rep,
                                         PHASE7_CUT_NEW)
        del engine
        release_device_memory()
    ng = runs["spec_ngram"]
    check(ng["spec_proposed"] > 0 and ng["verify_dispatches"] > 0,
          "7b: no draft proposed or no verify row dispatched")
    log(f"[serve:7b] seconds={time.perf_counter() - t0} first differing "
        f"output token, speculation on against off, per request (-1: "
        f"equal): {first_divergence(ng['outputs'], runs['spec_off']['outputs'])}")

    t0 = time.perf_counter()
    draft = LlamaForCausalLM(tinyllama_config(dtype="bfloat16"), seed=1)
    engine = ServingEngine.from_model(model, spec="draft", draft_model=draft,
                                      **knobs)
    # 4 requests (cut from 8: the run stays inside half its time limit)
    runs["spec_draft"] = serve_run(engine, "spec_draft", rep[:4], 32)
    check(runs["spec_draft"]["draft_dispatches"] > 0,
          "7c: the draft model made no dispatch")
    log(f"[serve:7c] seconds={time.perf_counter() - t0} draft weight_bytes="
        f"{sum(p.numel() * p.element_size() for p in draft.parameters())}")
    del engine, draft
    release_device_memory()
    runs.update(phase_hosttier(model, knobs))
    phase_guardrails(model, knobs)
    runs.update(phase_telemetry_serving(model, knobs, card,
                                        runs["main"]["outputs"]))
    runs.update(phase_fleet_serving(model, knobs, card))
    # quantizes the model in place: its last use
    runs.update(phase_int8_serving(model, knobs, card))
    del model
    release_device_memory()
    check_released("phase 7", base)
    return runs


def warm_serving(model, knobs):
    """Warm-up outside the timed runs (first cuBLAS calls, allocator):
    one request through a throwaway engine with a small pool."""
    from paddle_tpu_torch import ServingEngine

    warm = ServingEngine.from_model(model, pool_blocks=64, **knobs)
    warm.add_request(list(range(1, 129)), max_new_tokens=2)
    warm.run()


# phase 7h: bench.py's chip decode bench (bench.py:480-546): a 128-token
# prompt, 128 greedy new tokens, batches 1 and 8; tok/s = batch x new
# tokens over the seconds of one generate()
INT8_GEN_PROMPT, INT8_GEN_NEW, INT8_GEN_BATCHES = 128, 128, (1, 8)


def generate_tok_s(model, reps=1):
    """Greedy ``generate`` decode tok/s at each of INT8_GEN_BATCHES, as
    bench.py's ``int8_speedup`` counts them (prefill included): one short
    warm-up, then the median of ``reps`` timed calls. Returns {batch:
    tok/s}."""
    rng = np.random.RandomState(0)
    rates = {}
    for b in INT8_GEN_BATCHES:
        ids = torch.tensor(rng.randint(0, model.config.vocab_size,
                                       (b, INT8_GEN_PROMPT)), device="cuda")
        model.generate(ids, max_new_tokens=4)
        secs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.generate(ids, max_new_tokens=INT8_GEN_NEW)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        check(out.shape == (b, INT8_GEN_PROMPT + INT8_GEN_NEW),
              "7h: generate returned another shape")
        rates[b] = b * INT8_GEN_NEW / sorted(secs)[len(secs) // 2]
    return rates


def phase_int8_serving(model, knobs, card):
    """Phase 7h: full Llama-2-7B (32 layers) in bf16, then quantized in
    place (the model's last use), on phase 7's mix: zero loss and exact
    launches (K10 = 7 x 32 + 1 = 225, K5 = 32, K6 = 65 a dispatch), tok/s,
    TTFT, TPOT, phase seconds and the decode roofline for int8 against
    bf16, then int8's profile window (device ms a dispatch by family, the
    idle share, one prefill and one decode dispatch apart);
    ``generate`` decode tok/s at batch 1 and 8 both ways; linear weight
    memory and the decode step against the int8 weights' bound (1.97 ms
    at 3.35 TB/s)."""
    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.models.generation import quantize_for_decode

    t0 = time.perf_counter()
    cfg = model.config
    prompts = phase7_mix(cfg.vocab_size)
    n_lin, bf16_bytes = linear_weights(model)
    gen = {"bf16": generate_tok_s(model)}
    runs = {}
    peak_gbs = HBM_BYTES_S / 1e9

    def serve(label, per_dispatch):
        engine = ServingEngine.from_model(model, hbm_peak_gbs=peak_gbs,
                                          **knobs)
        r = serve_run(engine, label, prompts, 64,
                      k10_per_dispatch=per_dispatch)
        m = engine.metrics.snapshot()
        frac = m["decode_roofline_frac"]
        r.update(model_bytes=engine.model_bytes, decode_roofline_frac=frac,
                 decode_step_ms=(None if not frac else engine.model_bytes
                                 / (frac * HBM_BYTES_S) * 1e3),
                 phase_seconds=m["phase_seconds"])
        log(f"[serve:{label}] phase_seconds={json.dumps(m['phase_seconds'])}")
        if per_dispatch:
            # bf16's profile is phase 7's main run (the same dispatches)
            profile_window(engine, cfg.vocab_size)
        del engine
        release_device_memory()
        return r

    runs["7h-bf16"] = serve("7h-bf16", 0)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    quantize_for_decode(model)
    torch.cuda.synchronize()
    freed = before - torch.cuda.memory_allocated()
    _, int8_bytes = linear_weights(model)
    check(int8_bytes == n_lin == LLAMA7B_INT8_WEIGHTS and
          2 * int8_bytes == bf16_bytes, "7h: linear weights are not half of "
          "bf16's")
    warm_serving(model, knobs)
    gen["int8"] = generate_tok_s(model)
    runs["7h-int8"] = serve("7h-int8", 7 * LLAMA_LAYERS + 1)
    bound_ms = LLAMA7B_INT8_WEIGHTS / HBM_BYTES_S * 1e3
    b, q = runs["7h-bf16"], runs["7h-int8"]
    for key, r in runs.items():
        log(f"[serve:{key}] tok_s={r['output_tok_s']} ttft_p50_s="
            f"{r['ttft_p50_s']} ttft_p95_s={r['ttft_p95_s']} tpot_p50_s="
            f"{r['tpot_p50_s']} tpot_p95_s={r['tpot_p95_s']} model_bytes="
            f"{r['model_bytes']} decode_roofline_frac="
            f"{r['decode_roofline_frac']} decode_step_ms={r['decode_step_ms']}"
            f" k5={r['k5']} k6={r['k6']} k10={r['k10']} dispatches="
            f"{r['dispatches']} peak_memory_bytes={r['peak_memory_bytes']} "
            f"({card})")
    log(f"[serve:7h] int8/bf16: tok_s x{q['output_tok_s'] / b['output_tok_s']}"
        f" tpot_p50 x{q['tpot_p50_s'] / b['tpot_p50_s']}; generate decode "
        f"tok/s bf16 {gen['bf16']} int8 {gen['int8']} int8_speedup "
        f"{ {k: gen['int8'][k] / gen['bf16'][k] for k in gen['int8']} }; "
        f"linear weight bytes bf16 {bf16_bytes} int8 {int8_bytes}, card "
        f"memory freed by quantizing {freed}; decode step "
        f"{q['decode_step_ms']} ms against the int8 weights' bound "
        f"{bound_ms} ms (bf16 {b['decode_step_ms']} ms); first differing "
        f"token int8 against bf16 per request: "
        f"{first_divergence(q['outputs'], b['outputs'])} (quantization "
        f"moves the logits; phase 6 holds the int8 tokens to dense "
        f"generate in f32); seconds={time.perf_counter() - t0} ({card})")
    runs["7h-int8"]["generate_tok_s"] = gen["int8"]
    runs["7h-bf16"]["generate_tok_s"] = gen["bf16"]
    return runs


def tier_only():
    """``--tier``: the host tier, the robustness contract and telemetry
    alone: build K5 and K6, run phase 6's host-tier, fault, telemetry and
    handoff checks (f32, 2 layers at Llama-2-7B width), then phases 7d,
    7e and 7f on full Llama-2-7B in bf16. Prints no result line."""
    from paddle_tpu_torch import LlamaConfig, LlamaForCausalLM, ServingEngine
    from paddle_tpu_torch.ops.hopper import paged_attention, rms_norm

    _, _, card = phase_device()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(lambda build: build(), (paged_attention.build,
                                              rms_norm.build)))
    log(f"[build] seconds={time.perf_counter() - t0}")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaForCausalLM(LlamaConfig.llama2_7b(num_hidden_layers=2,
                                                   dtype="float32"), seed=0)
    phase_parity_tier(model)
    prompts = phase6_prompts(model.config.vocab_size)
    default_out = _engine_outputs(ServingEngine.from_model(model), prompts, 8)
    _check_greedy(model, "default", prompts, default_out, 8)
    phase_parity_telemetry(model, prompts, default_out)
    del model
    release_device_memory()
    model = LlamaForCausalLM(LlamaConfig.llama2_7b(dtype="bfloat16"), seed=0)
    knobs = dict(block_size=16, max_slots=8, prefill_chunk=128)
    warm_serving(model, knobs)
    phase_hosttier(model, knobs)
    phase_guardrails(model, knobs)
    phase_telemetry_serving(model, knobs, card)
    log(f"[tier] seconds={time.perf_counter() - t0}")
    return 0


def fleet_only():
    """``--fleet``: the fleet alone: build K5 and K6, run phase 6's fleet
    checks (f32, 2 layers at Llama-2-7B width), then phase 7g on full
    Llama-2-7B in bf16. Prints no result line."""
    from paddle_tpu_torch import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.ops.hopper import paged_attention, rms_norm

    _, _, card = phase_device()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(lambda build: build(), (paged_attention.build,
                                              rms_norm.build)))
    log(f"[build] seconds={time.perf_counter() - t0}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = LlamaForCausalLM(LlamaConfig.llama2_7b(num_hidden_layers=2,
                                                   dtype="float32"), seed=0)
    phase_parity_fleet(model, phase6_prompts(model.config.vocab_size))
    del model
    release_device_memory()
    check_released("phase 6's fleet", base)
    model = LlamaForCausalLM(LlamaConfig.llama2_7b(dtype="bfloat16"), seed=0)
    knobs = dict(block_size=16, max_slots=8, prefill_chunk=128)
    warm_serving(model, knobs)
    runs = phase_fleet_serving(model, knobs, card)
    log(f"[fleet] launches by run: "
        f"{ {k: (r['k5'], r['k6']) for k, r in runs.items()} }")
    del model
    release_device_memory()
    check_released("phase 7g", base)
    log(f"[fleet] seconds={time.perf_counter() - t0}")
    return 0


# phases 7a and 7b: 32 new tokens where bench.py has 64 (serve_prefix) and
# 128 (serve_spec); cut from 64 when phase 13 came (7a and 7b took 35-41 s
# each of 584-710 s runs): the whole run aims at half its time limit
PHASE7_CUT_NEW = 32


def phase7_mix(vocab):
    """Phase 7's requests: 8 prompts of 128-512 seeded tokens."""
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, n).tolist()
            for n in rng.integers(128, 513, 8)]


# phase 7d: bench.py's on-chip zipf-hosttier mix (bench.py:939-945), its
# 32 new tokens cut to 16 (at 32 the device and host runs took 51.9 and
# 54.0 s on the card, so the three would pass 150 s), and its 48 requests
# (drawn as bench.py draws them) cut to the first 32 (the three runs took
# 122 s of a 641 s run), then to the first 24 when phase 13 came (at 32
# they took 75-93 s of 584-710 s runs), then to the first 16 when phase
# 14 came (at 24 they took 65 s of a 685 s run, with 173 spills and 101
# restored blocks): the whole run aims at half its time limit
HOSTTIER_REQUESTS, HOSTTIER_PREFIXES, HOSTTIER_PREFIX_LEN = 48, 8, 192
HOSTTIER_RUN_REQUESTS = 16
HOSTTIER_SUFFIX, HOSTTIER_NEW = 32, 16
HOSTTIER_BYTES = 1 << 30


def hosttier_prompts(vocab, n_req=HOSTTIER_REQUESTS):
    return zipf_prompts(np.random.RandomState(7), vocab, HOSTTIER_REQUESTS,
                        HOSTTIER_PREFIXES, HOSTTIER_PREFIX_LEN,
                        HOSTTIER_SUFFIX)[:n_req]


def watch_round_trip(pool, keep=64):
    """Keep device copies of the blocks the pool spills (the latest spill
    of each of up to ``keep`` token paths) and, at the first restore of
    one of them, the block the restore wrote: ``seen["pair"]`` is then
    (spilled, restored). The copies are taken on the pool's stream, so
    they read the bytes before the spill and after the restore. Also
    sums the host seconds spent in the pool's spill and restore calls
    (enqueueing their copies; the copies themselves are asynchronous)."""
    seen = {"spilled": {}, "pair": None, "spill_host_s": 0.0,
            "restore_host_s": 0.0}
    spill, restore = pool._spill_path, pool._restore_chain

    def spill_probe(b, path):
        if seen["pair"] is None and (path in seen["spilled"]
                                     or len(seen["spilled"]) < keep):
            seen["spilled"][path] = pool._kv[:, :, b].clone()
        t0 = time.perf_counter()
        spill(b, path)
        seen["spill_host_s"] += time.perf_counter() - t0

    def restore_probe(seq_id, chain, keys, tokens):
        t0 = time.perf_counter()
        blocks = restore(seq_id, chain, keys, tokens)
        seen["restore_host_s"] += time.perf_counter() - t0
        if seen["pair"] is None:
            for key, b in zip(keys, blocks):
                if key in seen["spilled"]:
                    seen["pair"] = (seen["spilled"][key],
                                    pool._kv[:, :, b].clone())
                    seen["spilled"].clear()
                    break
        return blocks

    pool._spill_path, pool._restore_chain = spill_probe, restore_probe
    return seen


def tier_copy_ms(pool, iters=20):
    """CUDA-event ms of one block's copies as the host tier makes them:
    every layer's K and V of a free block to pinned host memory (a gather
    into a contiguous temporary, then one copy) and back (one copy, then
    a scatter); and the host ms of allocating one new pinned block, as a
    spill does when no freed one is cached (``iters`` allocations kept
    alive, so each is new). Returns (d2h ms, h2d ms, alloc ms, bytes a
    block)."""
    b = pool._free[-1]
    shape = pool._kv[:, :, b].shape
    host = torch.empty(shape, dtype=pool.dtype, pin_memory=True)
    d2h = time_ms(lambda: host.copy_(pool._kv[:, :, b], non_blocking=True),
                  iters)
    h2d = time_ms(lambda: pool._kv[:, :, b].copy_(host, non_blocking=True),
                  iters)
    t0 = time.perf_counter()
    kept = [torch.empty(shape, dtype=pool.dtype, pin_memory=True)
            for _ in range(iters)]
    alloc = (time.perf_counter() - t0) * 1e3 / iters
    del kept
    return d2h, h2d, alloc, host.numel() * host.element_size()


def phase_hosttier(model, knobs):
    """Phase 7d: bench.py's on-chip zipf-hosttier mix at full Llama-2-7B
    in bf16 (the first 16 of its 48 requests, 8 system prompts of 192
    tokens, Zipf 1.2, suffixes of 1-32, RandomState(7); 16 new tokens
    where bench.py has 32), sequential closed
    loop, three runs: ``device`` (unbounded cached set, a pool that holds
    everything), ``host`` (a cached set of 2 x 192/16 = 24 blocks, the
    host tier on with 1 GiB) and ``cold`` (24 blocks, tier off). Host
    tokens equal device tokens (restored bits are the spilled bits, and
    the replay runs the same shapes), host computes as many tokens as
    device, spills and host hits happen, one spilled block round-trips
    byte-equal; cold is reported by its first divergence (its bf16
    recompute runs in other shapes). Launches exact (serve_run). Each run
    also times one block's D2H and H2D copy with CUDA events."""
    from paddle_tpu_torch import ServingEngine

    t_start = time.perf_counter()
    vocab = model.config.vocab_size
    prompts = hosttier_prompts(vocab, HOSTTIER_RUN_REQUESTS)
    bs = knobs["block_size"]
    starved = 2 * (HOSTTIER_PREFIX_LEN // bs)
    check(HOSTTIER_PREFIXES * (HOSTTIER_PREFIX_LEN // bs) > starved,
          "7d: the hot prefixes must oversubscribe the cached set")
    runs = {}
    for mode in ("device", "host", "cold"):
        kw, fl = hosttier_setup(mode, prompts, HOSTTIER_NEW, starved, bs)
        fl["serving_host_tier_bytes"] = HOSTTIER_BYTES
        label = f"7d-{mode}"
        with port_flags(**fl):
            engine = ServingEngine.from_model(model, **kw, **knobs)
            watch = watch_round_trip(engine.pool) if mode == "host" else None
            r = serve_run(engine, label, prompts, HOSTTIER_NEW,
                          closed_loop=True)
            if engine.pool.host_tier is not None:
                r["tier"] = engine.pool.host_tier.stats()
            # under the run's flags: the tier checks its byte cap
            check(pool_clean(engine), f"{label}: the pool is not clean")
        if watch is not None:
            del engine.pool._spill_path, engine.pool._restore_chain
            check(watch["pair"] is not None, "7d: no spilled block was "
                  "restored")
            check(torch.equal(*watch["pair"]), "7d: a restored bf16 block "
                  "differs from the block spilled")
            r["round_trip_equal"] = True
            r["spill_host_s"] = watch["spill_host_s"]
            r["restore_host_s"] = watch["restore_host_s"]
            log(f"[serve:{label}] round_trip_equal=True spill_host_s="
                f"{watch['spill_host_s']} restore_host_s="
                f"{watch['restore_host_s']} (host seconds in the pool's "
                f"spill and restore calls over the run)")
            del watch
        d2h, h2d, alloc, nbytes = tier_copy_ms(engine.pool)
        r.update(d2h_ms_per_block=d2h, h2d_ms_per_block=h2d,
                 pinned_alloc_ms_per_block=alloc, block_bytes=nbytes)
        log(f"[serve:{label}] d2h_ms_per_block={d2h} h2d_ms_per_block={h2d}"
            f" pinned_alloc_ms_per_block={alloc} (host)"
            f" block_bytes={nbytes} d2h_gb_s={nbytes / d2h / 1e6} "
            f"h2d_gb_s={nbytes / h2d / 1e6} host_tier={r.get('tier')}")
        runs[f"7d_{mode}"] = r
        del engine
        release_device_memory()
    dev, host, cold = (runs[f"7d_{m}"] for m in ("device", "host", "cold"))
    check(host["outputs"] == dev["outputs"], "7d: host tokens differ from "
          "device tokens")
    check(host["tokens_computed"] == dev["tokens_computed"],
          f"7d: host computed {host['tokens_computed']} tokens, device "
          f"{dev['tokens_computed']}")
    check(host["host_tier_spills"] > 0 and host["host_tier_hits"] > 0,
          "7d: no spill or no host hit")
    log(f"[serve:7d] seconds={time.perf_counter() - t_start} tokens_computed "
        f"device/host/cold={dev['tokens_computed']}/{host['tokens_computed']}"
        f"/{cold['tokens_computed']} first differing output token, cold "
        f"against device, per request (-1: equal): "
        f"{first_divergence(cold['outputs'], dev['outputs'])}")
    return runs


def _drive_states(engine):
    """Step until no work is left; returns the finished Sequences by id
    and the lifecycle state after each step."""
    done, states = {}, []
    while engine.has_work():
        for seq in engine.step():
            done[seq.req_id] = seq
        states.append(engine.lifecycle.state)
    return done, states


def phase_guardrails(model, knobs):
    """Phase 7e, full Llama-2-7B in bf16, phase 7's 8-request mix: the
    robustness contract on the card, held by counts and states.
    ``serving.decode:times=1`` and ``serving.prefill:times=1``: every
    request ok, one step failure, one replay for each request of the
    failing plan and none for the others, SERVING -> DEGRADED -> SERVING
    after RECOVERY_CLEAN_STEPS clean steps, exact launches, a clean pool.
    ``serving.host_tier.restore:times=1`` in a short 7d-style run: one
    restore failure, every request ok without a retry, no leaked block.
    A deadline shorter than the request's decode: ``expired`` with
    partial output. A cancel in flight. ``serving_max_queue=4`` with 8
    arrivals: 4 sheds (``queue_full``). ``drain()`` to STOPPED."""
    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.ops.hopper.paged_attention import paged_attend_cuda
    from paddle_tpu_torch.ops.hopper.rms_norm import rms_norm_cuda
    from paddle_tpu_torch.serving import RequestRejected
    from paddle_tpu_torch.serving.robustness import RECOVERY_CLEAN_STEPS

    t_start = time.perf_counter()
    prompts = phase7_mix(model.config.vocab_size)
    for site in ("decode", "prefill"):
        with port_flags(fault_spec=f"serving.{site}:times=1"):
            engine = ServingEngine.from_model(model, **knobs)
            blamed = []
            on_failure = engine._on_phase_failure

            def record(planned, phase, exc, finished, _f=on_failure):
                blamed.extend(s.req_id for s in planned)
                _f(planned, phase, exc, finished)
            engine._on_phase_failure = record
            paged_attend_cuda.launches = rms_norm_cuda.launches = 0
            rids = [engine.add_request(p, max_new_tokens=32) for p in prompts]
            done, states = _drive_states(engine)
            k5, k6 = paged_attend_cuda.launches, rms_norm_cuda.launches
            del engine._on_phase_failure
        retries = {r: done[r].retries for r in rids}
        first = states.index("degraded") if "degraded" in states else -1
        log(f"[serve:7e] serving.{site}:times=1 blamed={blamed} retries="
            f"{retries} step_failures={engine.metrics.step_failures} "
            f"states={states} dispatches={engine.dispatches} k5={k5} k6={k6}")
        check(all(done[r].outcome == "ok" and len(done[r].output) == 32
                  for r in rids), f"7e {site}: a request did not finish ok")
        check(engine.metrics.step_failures == {site: 1},
              f"7e {site}: step failures {engine.metrics.step_failures}")
        check(len(blamed) >= 1 and retries == {
            r: int(r in blamed) for r in rids}, f"7e {site}: retries "
            f"{retries}, blamed {blamed}")
        check(first >= 0 and states[first:first + RECOVERY_CLEAN_STEPS]
              == ["degraded"] * RECOVERY_CLEAN_STEPS
              and states[first + RECOVERY_CLEAN_STEPS] == "serving",
              f"7e {site}: lifecycle {states}")
        check(k5 == LLAMA_LAYERS * engine.dispatches
              and k6 == (2 * LLAMA_LAYERS + 1) * engine.dispatches,
              f"7e {site}: launches K5 {k5} K6 {k6} for "
              f"{engine.dispatches} dispatches")
        check(pool_clean(engine), f"7e {site}: the pool is not clean")
        del engine
        release_device_memory()

    short = hosttier_prompts(model.config.vocab_size, 12)
    kw, fl = hosttier_setup("host", short, 8, 2 * (HOSTTIER_PREFIX_LEN
                                                   // knobs["block_size"]),
                            knobs["block_size"])
    with port_flags(fault_spec="serving.host_tier.restore:times=1",
                    serving_host_tier_bytes=HOSTTIER_BYTES, **fl):
        engine = ServingEngine.from_model(model, **kw, **knobs)
        seqs = closed_loop(engine, short, 8)
        pool = engine.pool
        tier = pool.host_tier.stats()
        clean = pool_clean(engine)
    log(f"[serve:7e] serving.host_tier.restore:times=1 restore_failures="
        f"{pool.host_restore_failures} host_hits={pool.host_hits} "
        f"tier={tier} retries={[s.retries for s in seqs]}")
    check(pool.host_restore_failures == 1, "7e restore: want one restore "
          "failure")
    check(all(s.outcome == "ok" and s.retries == 0 for s in seqs),
          "7e restore: a request did not finish ok without a retry")
    check(clean, "7e restore: a block leaked")
    del engine, pool
    release_device_memory()

    engine = ServingEngine.from_model(model, **knobs)
    # the deadline: twice one 8-token run of the same prompt, so the
    # request (its prefix cached by then) expires mid-decode
    t0 = time.perf_counter()
    closed_loop(engine, prompts[:1], 8)
    probe_s = time.perf_counter() - t0
    rid = engine.add_request(prompts[0], max_new_tokens=128,
                             deadline_s=2 * probe_s)
    seq = engine.run()[rid]
    log(f"[serve:7e] deadline_s={2 * probe_s} outcome={seq.outcome} "
        f"output_tokens={len(seq.output)}")
    check(seq.outcome == "expired" and 1 <= len(seq.output) < 128,
          f"7e deadline: outcome {seq.outcome} with {len(seq.output)} tokens")

    r1 = engine.add_request(prompts[1], max_new_tokens=32)
    r2 = engine.add_request(prompts[2], max_new_tokens=32)
    while not engine.requests[r1].output:
        engine.step()
    cancelled = engine.cancel(r1)
    done = engine.run()
    log(f"[serve:7e] cancel: outcome={cancelled.outcome} output_tokens="
        f"{len(cancelled.output)} other={done[r2].outcome}")
    check(cancelled.outcome == "cancelled" and cancelled.output
          and engine.pool.table(r1) == [] and r1 not in done
          and done[r2].outcome == "ok", "7e cancel")

    causes = []
    with port_flags(serving_max_queue=4):
        for p in prompts:
            try:
                engine.add_request(p, max_new_tokens=8)
            except RequestRejected as e:
                causes.append(e.cause)
    done = engine.run()
    log(f"[serve:7e] max_queue=4, 8 arrivals: sheds={engine.metrics.sheds} "
        f"causes={causes} finished={len(done)}")
    check(causes == ["queue_full"] * 4
          and engine.metrics.sheds == {"queue_full": 4}
          and sorted(s.outcome for s in done.values()) == ["ok"] * 4,
          "7e shedding")

    rids = [engine.add_request(p, max_new_tokens=8) for p in prompts[:2]]
    done = engine.drain()
    try:
        engine.add_request(prompts[0], max_new_tokens=8)
        refused = None
    except RequestRejected as e:
        refused = e.cause
    log(f"[serve:7e] drain: state={engine.lifecycle.state} outcomes="
        f"{[done[r].outcome for r in rids]} refused={refused} "
        f"terminal={engine.metrics.terminal} seconds="
        f"{time.perf_counter() - t_start}")
    check(engine.lifecycle.state == "stopped" and refused == "draining"
          and all(done[r].outcome == "ok" for r in rids), "7e drain")
    check(pool_clean(engine), "7e: the pool is not clean")
    del engine
    release_device_memory()


# -- phase 7f: serving with telemetry on ---------------------------------------

def _series(snap, name, **labels):
    """The value of one counter or gauge series of a telemetry snapshot
    (None when absent)."""
    want = {k: str(v) for k, v in labels.items()}
    for s in snap.get(name, {}).get("samples", []):
        if s["labels"] == want:
            return s["value"]
    return None


def parse_prometheus(text):
    """The exposition text line by line: ``# TYPE name kind`` or
    ``name{labels} value`` with a float value; raises on anything else.
    Returns the number of samples."""
    n = 0
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            check(len(line.split()) == 4, f"prometheus: {line!r}")
            continue
        body, value = line.rsplit(" ", 1)
        float(value)
        name = body.split("{", 1)[0]
        check(re.fullmatch(r"[a-z][a-z0-9_]*", name) is not None
              and ("{" not in body or body.endswith("}")),
              f"prometheus: {line!r}")
        n += 1
    return n


def span_host_us(telemetry, rounds=5, calls=1000):
    """Host microseconds of one ``telemetry.span`` enter and exit, the
    least of ``rounds`` rounds of ``calls``."""
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            with telemetry.span("smoke/span", cat="Smoke", step=1):
                pass
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    return best


def phase_telemetry_serving(model, knobs, card, main_outputs=None):
    """Phase 7f, full Llama-2-7B in bf16, phase 7's 8-request mix and
    knobs, with ``hbm_peak_gbs`` at the card's HBM peak: telemetry off,
    on, on, off (fresh engines, launches exact in each). The telemetry-on
    tokens equal the telemetry-off ones (and phase 7's main run, when
    given); the counters agree with the engine (steps, 8 requests, 8
    ``ok``, the ledger's kinds sum to the tokens computed, goodput ratio
    1.0); one ``serving/engine_step`` span a step; ``chrome_trace()``
    parses with one row a request and ``prometheus_text()`` line by line.
    Then ``serving.decode:times=1`` once more, which writes exactly one
    flight dump naming the failing step, and one request handed off
    mid-decode to a second engine with its own pool: it finishes ok with
    byte-equal imported blocks, its tokens logged against the unmoved
    run's. Prints the on/off wall time a dispatch and tok/s, a span's
    host µs off and on, the decode roofline, the attention-bytes share,
    and the handoff's bytes and ms, each beside ``card``. Returns the
    runs' numbers."""
    from paddle_tpu_torch import ServingEngine, telemetry

    t_start = time.perf_counter()
    prompts = phase7_mix(model.config.vocab_size)
    peak_gbs = HBM_BYTES_S / 1e9
    root = os.path.join(HERE, "build", "telemetry-7f")
    shutil.rmtree(root, ignore_errors=True)
    span_us = {"off": span_host_us(telemetry)}
    with port_flags(telemetry=True):
        span_us["on"] = span_host_us(telemetry)
        telemetry.reset_all()
    runs = {}
    for i, mode in enumerate(("off", "on", "on", "off")):
        label = f"7f-{mode}-{i}"
        flight_dir = os.path.join(root, label)
        with port_flags(telemetry=mode == "on",
                        telemetry_flight_dir=flight_dir):
            telemetry.reset_all()
            engine = ServingEngine.from_model(model, hbm_peak_gbs=peak_gbs,
                                              **knobs)
            gc0 = [g["collections"] for g in gc.get_stats()]
            r = serve_run(engine, label, prompts, 64)
            m, ms = engine.metrics, engine.metrics.snapshot()
            r.update(decode_roofline_frac=ms["decode_roofline_frac"],
                     attn_bytes_frac=ms["attn_bytes_frac"],
                     ms_per_dispatch=r["wall_s"] / r["dispatches"] * 1e3,
                     phase_seconds=ms["phase_seconds"],
                     gc_collections=[g["collections"] - c for g, c in
                                     zip(gc.get_stats(), gc0)])
            log(f"[serve:{label}] phase_seconds={r['phase_seconds']} "
                f"gc_collections_by_generation={r['gc_collections']}")
            if mode == "on":
                snap = telemetry.snapshot()
                kinds = snap["serving_tokens_total"]["samples"]
                spans = telemetry.snapshot_spans()
                steps = sum(s["name"] == "serving/engine_step"
                            for s in spans)
                trace = json.loads(json.dumps(telemetry.chrome_trace()))
                rows = [e for e in trace["traceEvents"]
                        if e["ph"] == "M" and e["name"] == "thread_name"]
                samples = parse_prometheus(telemetry.prometheus_text())
                log(f"[serve:{label}] engine_steps_total="
                    f"{_series(snap, 'serving_engine_steps_total')} "
                    f"steps={m.steps} requests_total="
                    f"{_series(snap, 'serving_requests_total')} ok="
                    f"{_series(snap, 'serving_terminal_total', reason='ok')} "
                    f"tokens_by_kind={[(s['labels'], s['value']) for s in kinds]}"
                    f" tokens_computed={m.tokens_computed} goodput_ratio="
                    f"{_series(snap, 'serving_goodput_ratio')} "
                    f"engine_step_spans={steps} spans={len(spans)} "
                    f"trace_events={len(trace['traceEvents'])} "
                    f"request_rows={len(rows)} prometheus_samples={samples} "
                    f"flight_digests={len(telemetry.flight().snapshot())}")
                check(_series(snap, "serving_engine_steps_total") == m.steps,
                      f"{label}: engine_steps_total against the engine")
                check(_series(snap, "serving_requests_total") == 8
                      and _series(snap, "serving_terminal_total",
                                  reason="ok") == 8,
                      f"{label}: requests or ok outcomes")
                check(sum(s["value"] for s in kinds) == m.tokens_computed
                      == sum(m.ledger.values()),
                      f"{label}: the ledger's kinds against tokens computed")
                check(_series(snap, "serving_goodput_ratio") == 1.0,
                      f"{label}: goodput ratio")
                check(steps == m.steps, f"{label}: engine_step spans")
                check(len(rows) == len(prompts), f"{label}: request rows")
                check(not os.path.exists(flight_dir),
                      f"{label}: a flight dump in a clean run")
            runs[label] = r
            del engine
            release_device_memory()
    off, on = runs["7f-off-0"], runs["7f-on-1"]
    for label in ("7f-on-1", "7f-on-2", "7f-off-3"):
        div = first_divergence(runs[label]["outputs"], off["outputs"])
        log(f"[serve:7f] {label} against 7f-off-0, first differing output "
            f"token per request (-1: equal): {div}")
        check(runs[label]["outputs"] == off["outputs"],
              f"7f: {label} tokens differ from the telemetry-off run")
    if main_outputs is not None:
        div = first_divergence(off["outputs"], main_outputs)
        log(f"[serve:7f] 7f-off-0 against phase 7's main run: {div}")
        check(off["outputs"] == main_outputs,
              "7f: tokens differ from phase 7's main run")
    for mode, labels in (("off", ("7f-off-0", "7f-off-3")),
                         ("on", ("7f-on-1", "7f-on-2"))):
        log(f"[serve:7f] telemetry {mode}: ms_per_dispatch="
            f"{[runs[k]['ms_per_dispatch'] for k in labels]} output_tok_s="
            f"{[runs[k]['output_tok_s'] for k in labels]} ({card})")
    log(f"[serve:7f] span host us (least of 5 x 1000): off={span_us['off']}"
        f" on={span_us['on']} ({card})")
    log(f"[serve:7f] decode_roofline_frac={on['decode_roofline_frac']} "
        f"attn_bytes_frac={on['attn_bytes_frac']} (hbm_peak_gbs="
        f"{peak_gbs}; {card})")
    check(on["decode_roofline_frac"] is not None
          and 0.0 < on["decode_roofline_frac"] < 1.0,
          f"7f: decode roofline {on['decode_roofline_frac']}")

    flight_dir = os.path.join(root, "fault")
    with port_flags(telemetry=True, telemetry_flight_dir=flight_dir,
                    fault_spec="serving.decode:times=1"):
        telemetry.reset_all()
        engine = ServingEngine.from_model(model, hbm_peak_gbs=peak_gbs,
                                          **knobs)
        failed = []
        on_failure = engine._on_phase_failure

        def record(planned, phase, exc, finished, _f=on_failure):
            failed.append((engine.metrics.steps, [s.req_id for s in planned]))
            _f(planned, phase, exc, finished)
        engine._on_phase_failure = record
        runs["7f-fault"] = serve_run(engine, "7f-fault", prompts, 16)
        del engine._on_phase_failure
        files = sorted(os.listdir(flight_dir))
        check(len(files) == 1 and len(failed) == 1,
              f"7f fault: dumps {files}, failures {failed}")
        with open(os.path.join(flight_dir, files[0])) as f:
            doc = json.load(f)
        step, rids = failed[0]
        retried = sorted(int(r) for r, tl in doc["requests"].items()
                         if any(e["kind"] == "retry" for e in tl["events"]))
        log(f"[serve:7f] fault dump {files[0]}: trigger={doc['trigger']} "
            f"extra={doc['extra']} health.steps={doc['health']['steps']} "
            f"last digest step={doc['digests'][-1]['step']} failing step="
            f"{step} rids={rids} retried={retried}")
        check(doc["trigger"] == "degraded" and doc["extra"]["phase"] == "decode"
              and doc["health"]["steps"] == step
              and doc["digests"][-1]["step"] == step - 1
              and retried == sorted(rids),
              "7f fault: the dump does not name the failing step")
        del engine
        release_device_memory()

    with port_flags(telemetry=True):
        telemetry.reset_all()
        src = ServingEngine.from_model(model, pool_blocks=160, **knobs)
        dst = ServingEngine.from_model(model, pool_blocks=160, **knobs)
        rid = src.add_request(prompts[0], max_new_tokens=64)
        while not (rid in src.handoff_ready()
                   and len(src.requests[rid].output) >= 4):
            src.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = src.export_request(rid)
        export_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        new = dst.import_request(state)
        torch.cuda.synchronize()
        import_ms = (time.perf_counter() - t0) * 1e3
        equal = _moved_blocks_equal(dst, new, state)
        src.release_handoff(rid, dest=1)
        check(equal, "7f handoff: imported blocks differ from the manifest")
        check(not src.has_work() and pool_clean(src),
              "7f handoff: the source still holds work or blocks")
        seq = dst.run()[new]
        timeline = telemetry.request_timeline(new)
        div = first_divergence([seq.output_ids], [off["outputs"][0]])
        log(f"[serve:7f] handoff mid-decode: ctx={state['ctx']} "
            f"manifest_bytes={state['kv']['nbytes']} export_ms={export_ms} "
            f"import_ms={import_ms} blocks_equal={equal} outcome="
            f"{seq.outcome} tokens={len(seq.output)} first differing token "
            f"against the unmoved run (-1: equal): {div[0]} (bf16 in "
            f"another dispatch shape may round apart; phase 6 holds the f32 "
            f"tokens equal) ({card})")
        check(seq.outcome == "ok" and len(seq.output) == 64
              and timeline["events"][0]["kind"] == "handoff_in",
              "7f handoff: the moved request did not finish ok")
        check(pool_clean(dst), "7f handoff: the destination pool is not "
              "clean")
        telemetry.reset_all()
        del src, dst
        release_device_memory()
    shutil.rmtree(root, ignore_errors=True)
    log(f"[serve:7f] seconds={time.perf_counter() - t_start}")
    return runs


# K5's family: its split kernels (paged_attend_kernel_cc, _tc) and merge
KERNEL_FAMILIES = (("k5_paged_attention", ("paged_attend_kernel",)),
                   ("k6_rms_norm", ("rms_norm_fwd",)),
                   ("k10_int8_matmul", ("int8_mm_",)),
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
    del engine._dispatch
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
    del engine._dispatch        # back to the method, no reference cycle
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


# -- phase 6 (fleet) and 7g: the serving fleet --------------------------------

# the fleet's healing knobs in phases 6 and 7g: bench.py fleet ramp's
# (bench.py:1787-1789): a respawn waits 0.05 s and is probed after 2 clean
# steps
FLEET_HEAL = dict(serving_fleet_respawn_backoff_s=0.05,
                  serving_fleet_respawn_backoff_max_s=0.5,
                  serving_fleet_join_steps=2)
# phase 7g's pools: 512 blocks of 16 tokens (8 MiB a block at Llama-2-7B in
# bf16, 4 GiB a replica) hold every request of its mixes at once
FLEET_POOL_BLOCKS = 512
# phase 7g (iv): bench.py fleet ramp's on-chip profile (bench.py:1776-1786)
RAMP_SEGMENTS = ((2.0, 8.0), (16.0, 6.0), (2.0, 8.0))
RAMP_PROMPT, RAMP_NEW = 128, 32
RAMP_FLAGS = dict(serving_fleet_min_replicas=1, serving_fleet_max_replicas=4,
                  serving_fleet_scale_cooldown_s=2.0,
                  serving_fleet_scale_window_steps=8,
                  serving_fleet_scale_up_occupancy=0.85,
                  serving_fleet_scale_down_occupancy=0.30,
                  serving_fleet_migrate=True, **FLEET_HEAL)


class DispatchTally:
    """Counts the target dispatches of every engine it watches: every
    replica a fleet ever built, its respawns, scale-ups and readiness
    probes included, and a hung step's late return. A lock keeps the count
    exact while replicas step on threads of their own; every dispatch's
    logits are held finite. The engines are held weakly, so a replica the
    router lets go of is freed as before."""

    def __init__(self):
        self.n = 0
        self.finite = True
        self._lock = threading.Lock()
        self.built = []     # a weak reference to every engine watched

    def watch(self, engine):
        ref = weakref.ref(engine)
        self.built.append(ref)
        for name in ("_dispatch", "_dispatch_full"):
            def counted(*args, _fn=getattr(type(engine), name)):
                out = _fn(ref(), *args)
                with self._lock:
                    self.n += 1
                    self.finite = self.finite and bool(np.isfinite(out).all())
                return out
            setattr(engine, name, counted)
        return engine

    def factory(self, model, **kw):
        from paddle_tpu_torch import ServingEngine

        def build():
            return self.watch(ServingEngine.from_model(model, **kw))
        return build

    def alive(self):
        """What still holds each watched engine that was not freed: the
        types of its referrers, two levels up (a leak's postmortem)."""
        out = []
        for i, ref in enumerate(self.built):
            engine = ref()
            if engine is None:
                continue
            chain = []
            for r in gc.get_referrers(engine):
                if r is self.built:
                    continue
                chain.append((type(r).__name__, sorted(
                    {type(r2).__name__ for r2 in gc.get_referrers(r)})))
            out.append((i, chain))
            del engine
        return out

    def zero(self):
        """Zero this tally and the K5 and K6 launch counts together."""
        from paddle_tpu_torch.ops.hopper.paged_attention import (
            paged_attend_cuda)
        from paddle_tpu_torch.ops.hopper.rms_norm import rms_norm_cuda

        paged_attend_cuda.launches = rms_norm_cuda.launches = 0
        self.n, self.finite = 0, True

    def check(self, label, layers):
        """K5 = layers x dispatches, K6 = (2 x layers + 1) x dispatches,
        every logit finite; returns (K5, K6)."""
        from paddle_tpu_torch.ops.hopper.paged_attention import (
            paged_attend_cuda)
        from paddle_tpu_torch.ops.hopper.rms_norm import rms_norm_cuda

        k5, k6 = paged_attend_cuda.launches, rms_norm_cuda.launches
        check(self.finite, f"{label}: non-finite logits")
        check(k5 == layers * self.n and k6 == (2 * layers + 1) * self.n,
              f"{label}: launches K5={k5} K6={k6} against {self.n} "
              f"dispatches of {layers} layers")
        return k5, k6


def drive_fleet(fleet, done=None, max_steps=100000):
    """Step ``fleet`` until it has no work; returns the finished Sequences
    by fleet rid."""
    done = {} if done is None else done
    for _ in range(max_steps):
        if not fleet.has_work():
            return done
        done.update(fleet.step())
    raise SmokeFailure(f"the fleet still has work after {max_steps} steps")


def heal_fleet(fleet, seconds=60.0):
    """Step an idle fleet until every slot is live and none is JOINING."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        h = fleet.health()
        if h["live"] == len(fleet.replicas) and not h["joining"]:
            return
        fleet.step()
        time.sleep(0.002)
    raise SmokeFailure(f"the fleet did not heal: {fleet.health()}")


def fleet_outputs(fleet, requests, heal=False):
    """Submit ``requests`` ((prompt, kwargs) pairs) in one burst, run the
    fleet dry (with ``heal``, on until every slot is SERVING again) and
    drain it; every request must finish ok. Returns the output ids in
    submission order."""
    frids = [fleet.submit(p, **kw) for p, kw in requests]
    done = drive_fleet(fleet)
    if heal:
        heal_fleet(fleet)
    done.update(fleet.drain())
    check(sorted(done) == sorted(frids), "fleet: a request was lost")
    check(all(done[f].outcome == "ok" for f in frids),
          f"fleet: outcomes {[done[f].outcome for f in frids]}")
    return [done[f].output_ids for f in frids]


def fleet_pools_clean(fleet, label):
    for rep in fleet.replicas.values():
        if not rep.dead:
            check(pool_clean(rep.engine), f"{label}: replica "
                  f"{rep.replica_id}'s pool is not clean")


def phase_parity_fleet(model, prompts):
    """Phase 6, the fleet (f32, 2 layers at Llama-2-7B width), on phase
    6's prompts and a seeded stochastic request: a 2-replica monolithic
    fleet gives the single engine's tokens; the same fleet with replica 1
    killed once at its third step and an ``engine_factory`` loses nothing,
    respawns the slot through JOINING and gives the same tokens; a 1:1
    prefill/decode fleet hands every request off exactly once and gives
    the monolithic tokens with speculation off and n-gram; one request
    moved mid-decode and one mid-prefill by ``migrate_one`` give the
    unmoved tokens. Launches are exact in every fleet."""
    from paddle_tpu_torch import ServingEngine
    from paddle_tpu_torch.serving.fleet import EngineReplica, FleetRouter

    t0 = time.perf_counter()
    layers = model.config.num_hidden_layers
    requests = [(p, dict(max_new_tokens=8)) for p in prompts]
    requests.append((prompts[1], dict(max_new_tokens=8, temperature=0.9,
                                      top_k=16, seed=23)))
    single = ServingEngine.from_model(model)
    rids = [single.add_request(p, **kw) for p, kw in requests]
    done = single.run()
    want = [done[r].output_ids for r in rids]
    del single, done
    _check_greedy(model, "fleet reference", prompts, want[:len(prompts)], 8)
    tally = DispatchTally()

    def fleet_of(factory, roles=("both", "both")):
        return FleetRouter([EngineReplica(i, factory(), role=r)
                            for i, r in enumerate(roles)],
                           engine_factory=factory)

    tally.zero()
    fleet = fleet_of(tally.factory(model))
    mono = fleet_outputs(fleet, requests)
    tally.check("fleet monolithic", layers)
    log(f"[parity] fleet monolithic: routed={fleet.routed} tokens equal "
        f"single engine={mono == want} dispatches={tally.n}")
    check(mono == want, f"fleet monolithic: tokens differ from the single "
          f"engine at {first_divergence(mono, want)}")
    fleet_pools_clean(fleet, "fleet monolithic")
    del fleet

    with port_flags(fault_spec="serving.fleet.replica:key=1:after=2:times=1",
                    **FLEET_HEAL):
        tally.zero()
        fleet = fleet_of(tally.factory(model))
        got = fleet_outputs(fleet, requests, heal=True)
        h = fleet.health()
        tally.check("fleet death", layers)
    log(f"[parity] fleet death: deaths={fleet.deaths} respawns="
        f"{fleet.respawns} routed={fleet.routed} live={h['live']} joining="
        f"{h['joining']} tokens equal fault-free={got == mono}")
    check(fleet.deaths == [1] and fleet.respawns == 1
          and fleet.routed["reroute"] >= 1,
          f"fleet death: deaths {fleet.deaths}, respawns {fleet.respawns}")
    check(got == mono, f"fleet death: tokens differ from the fault-free "
          f"fleet at {first_divergence(got, mono)}")
    del fleet

    for spec in ("off", "ngram"):
        factory = tally.factory(model, spec=spec)
        ref = mono
        if spec != "off":
            ref = fleet_outputs(fleet_of(factory), requests)
        tally.zero()
        fleet = fleet_of(factory, roles=("prefill", "decode"))
        got = fleet_outputs(fleet, requests)
        tally.check(f"fleet split spec={spec}", layers)
        h = fleet.health()
        pre = fleet.replicas[0].engine.health()["handoffs"]
        log(f"[parity] fleet 1:1 spec={spec}: ledger={h['handoffs']} "
            f"prefill handoffs={pre} tokens equal monolithic={got == ref}")
        check(h["handoffs"] == {"pending": 0, "begun": len(requests),
                                "committed": len(requests), "aborted": 0}
              and pre["out"] == len(requests),
              f"fleet split spec={spec}: not every request handed off once")
        check(got == ref, f"fleet split spec={spec}: tokens differ from "
              f"the monolithic fleet at {first_divergence(got, ref)}")
        fleet_pools_clean(fleet, f"fleet split spec={spec}")
        del fleet

    long_prompt = np.random.default_rng(9).integers(
        0, model.config.vocab_size, 200).tolist()
    reqs = [(prompts[1], dict(max_new_tokens=8)),
            (long_prompt, dict(max_new_tokens=8))]
    unmoved = fleet_outputs(fleet_of(tally.factory(model)), reqs)
    tally.zero()
    fleet = fleet_of(tally.factory(model))
    frids = [fleet.submit(p, **kw) for p, kw in reqs]
    done, where = {}, {}
    while len(where) < 2:
        check(fleet.has_work(), "fleet migration: the fleet ran out of work")
        done.update(fleet.step())
        for frid, at in zip(frids, ("mid-decode", "mid-prefill")):
            rr = fleet.requests[frid]
            if frid in where or rr.replica_id is None:
                continue
            src = fleet.replicas[rr.replica_id]
            seq = src.engine.requests.get(rr.local_rid)
            ready = (seq is not None
                     and rr.local_rid in src.engine.migrate_ready()
                     and (len(seq.output) == 4 if at == "mid-decode"
                          else seq.state == "prefill"))
            if ready:
                ctx = seq.ctx
                check(fleet._migrate.migrate_one(src, rr.local_rid,
                                                 reason="phase 6"),
                      f"fleet migration {at}: migrate_one refused")
                where[frid] = (at, ctx, src.replica_id, rr.replica_id)
    drive_fleet(fleet, done)
    done.update(fleet.drain())
    got = [done[f].output_ids for f in frids]
    tally.check("fleet migration", layers)
    counts = fleet._migrate.ledger.counts()
    log(f"[parity] fleet migration (where, ctx, from, to)="
        f"{[where[f] for f in frids]} ledger={counts} tokens equal "
        f"unmoved={got == unmoved}")
    check(counts["committed"] == 2 and counts["pending"] == 0,
          f"fleet migration: ledger {counts}")
    check(got == unmoved, f"fleet migration: tokens differ from the "
          f"unmoved run at {first_divergence(got, unmoved)}")
    check(all(done[f].outcome == "ok" for f in frids),
          "fleet migration: a moved request did not finish ok")
    fleet_pools_clean(fleet, "fleet migration")
    del fleet
    log(f"[parity] fleet seconds={time.perf_counter() - t0}")


def fleet_mix(vocab):
    """Phase 7g's mix: bench.py fleet's on-chip workload
    (bench.py:1525-1527), draw for draw from RandomState(0): 32 requests
    on 4 system prompts of 192 tokens (Zipf 1.2, suffixes of 1-32), the
    seed-wave rewrite (one request per prefix first, bench.py:1554-1555),
    bench.py's warm-up draws for its 2 replicas at its prefill chunk of
    256 (bench.py:583-597; the port warms on its own), then Poisson
    arrivals at 8/s. Returns (prompts, arrivals in seconds from the
    start)."""
    rng = np.random.RandomState(0)
    prompts, prefixes = zipf_prompts(rng, vocab, 32, 4, 192, 32,
                                     with_prefixes=True)
    for i, pfx in enumerate(prefixes):
        prompts[i] = pfx + prompts[i][192:]
    for _ in range(2):
        b = 1
        while b <= 256:
            rng.randint(0, vocab, (b,))
            b *= 2
    arrivals, t = [], 0.0
    for _ in range(32):
        arrivals.append(t)
        t += rng.exponential(1.0 / 8.0)
    return prompts, arrivals


def warm_replica(engine, seed):
    """bench.py's ``_warm_serving_engine`` (bench.py:583-607): one request
    of 2 new tokens for each prefill bucket, then the metrics reset; the
    engine's admission estimator keeps its throughput reading, as the
    replicas of bench.py fleet do."""
    rng = np.random.RandomState(seed)
    b = 1
    while b <= engine.prefill_chunk:
        engine.add_request(rng.randint(0, engine.model.config.vocab_size,
                                       (b,)).tolist(), max_new_tokens=2)
        b *= 2
    engine.run()
    engine.metrics.reset()
    return engine


def ramp_mix(vocab):
    """Phase 7g (iv)'s mix: bench.py fleet ramp's arrivals (a Poisson
    schedule at 2/s for 8 s, 16/s for 6 s, 2/s for 8 s) and prompts of
    128 tokens, draw for draw from RandomState(0) (bench.py:1812-1830)."""
    rng = np.random.RandomState(0)
    arrivals, t_end, t = [], 0.0, 0.0
    for rate, dur in RAMP_SEGMENTS:
        t_end += dur
        t = max(t, t_end - dur)
        while True:
            t += rng.exponential(1.0 / rate)
            if t >= t_end:
                t = t_end
                break
            arrivals.append(t)
    prompts = [rng.randint(0, vocab, (RAMP_PROMPT,)).tolist()
               for _ in arrivals]
    return prompts, arrivals


def replay(submit, step, has_work, arrivals, always_step=False):
    """bench.py's open-loop replay (``_drive_poisson``, bench.py:610) on
    the wall clock: request i is submitted once its arrival has passed,
    with ``arrival_s`` back-dated to it (TTFT includes the queueing), and
    the fleet steps while it has work; ``always_step`` keeps an armed
    autoscaler sampling between arrivals. Returns the start (now_s)."""
    from paddle_tpu_torch.serving.robustness import now_s

    t0 = now_s()
    submitted, n = 0, len(arrivals)
    while submitted < n or has_work():
        now = now_s() - t0
        while submitted < n and arrivals[submitted] <= now:
            submit(submitted, t0 + arrivals[submitted])
            submitted += 1
        busy = has_work()
        if busy or always_step:
            step()
        if not busy and submitted < n:
            time.sleep(max(0.0, min(arrivals[submitted] - now,
                                    0.01 if always_step else 0.05)))
    return t0


def run_fields(record):
    """A run record's numbers as ``key=value`` fields for a log line."""
    return " ".join(f"{k}={v}" for k, v in record.items()
                    if k not in ("label", "outputs"))


def latency(seqs):
    """TTFT and TPOT percentiles over finished Sequences (seconds)."""
    ttft = [s.first_token_s - s.arrival_s for s in seqs]
    tpot = [(s.last_token_s - s.first_token_s) / (len(s.output) - 1)
            for s in seqs if len(s.output) > 1]

    def pct(xs, q):
        return float(np.percentile(xs, q)) if xs else None
    return dict(ttft_p50_s=pct(ttft, 50), ttft_p95_s=pct(ttft, 95),
                tpot_p50_s=pct(tpot, 50), tpot_p95_s=pct(tpot, 95))


def probe_on_worker(replica):
    """One readiness probe through the replica's worker thread (started
    by it under a step budget)."""
    replica.dispatch(replica.engine.readiness_probe)
    return replica.collect(60.0) is True


class TimedHandoffs:
    """The router's handoff coordinator, its ``service`` passes timed
    (CUDA-synchronized wall seconds, summed)."""

    def __init__(self, inner):
        self.inner, self.ledger, self.seconds = inner, inner.ledger, 0.0

    def on_replica_death(self, replica_id):
        return self.inner.on_replica_death(replica_id)

    def service(self):
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = self.inner.service()
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t
        return n


class FleetRun:
    """One open-loop fleet run of phase 7g: launches zeroed just before
    and read just after (after joining any abandoned worker thread), the
    wall time of every fleet step with the live count at its start and
    its kind ("prefill" when a replica ran a prefill chunk in it, else
    "decode"), and the run's record for the ``kernels`` line."""

    def __init__(self, fleet, tally, label):
        self.fleet, self.tally, self.label = fleet, tally, label
        self.done, self.frids, self.steps = {}, [], []
        self.hooks = []

    def submit(self, prompt, at, max_new):
        self.frids.append(self.fleet.submit(prompt, max_new_tokens=max_new,
                                            arrival_s=at))

    def _prefill_s(self):
        return {rid: (r.engine, r.engine.metrics.phase_seconds["prefill"])
                for rid, r in self.fleet.replicas.items()}

    def step(self):
        live = len(self.fleet._live())
        before = self._prefill_s()
        t = time.perf_counter()
        self.done.update(self.fleet.step())
        ms = (time.perf_counter() - t) * 1e3
        after = self._prefill_s()
        prefill = any(rid in after and after[rid][0] is eng
                      and after[rid][1] > s for rid, (eng, s)
                      in before.items())
        del before, after
        self.steps.append((ms, live, "prefill" if prefill else "decode"))
        for hook in self.hooks:
            hook()

    def run(self, prompts, arrivals, max_new, always_step=False):
        torch.cuda.synchronize()
        self.tally.zero()
        t = time.perf_counter()
        self.t0 = replay(lambda i, at: self.submit(prompts[i], at, max_new),
                         self.step, self.fleet.has_work, arrivals,
                         always_step)
        torch.cuda.synchronize()
        self.wall = time.perf_counter() - t
        return self

    def finish(self, max_new, workers=()):
        """Drain, join abandoned workers, hold launches and outcomes."""
        self.done.update(self.fleet.drain(60.0))
        for w in workers:
            w.join(30.0)
            check(not w.is_alive(), f"{self.label}: an abandoned step "
                  f"never returned")
        torch.cuda.synchronize()
        k5, k6 = self.tally.check(self.label, LLAMA_LAYERS)
        seqs = [self.done.get(f) for f in self.frids]
        check(all(s is not None for s in seqs),
              f"{self.label}: a request was lost")
        check(all(s.outcome == "ok" and len(s.output) == max_new
                  for s in seqs),
              f"{self.label}: outcomes "
              f"{sorted(set(s.outcome for s in seqs))}")
        out_tokens = sum(len(s.output) for s in seqs)
        self.record = dict(label=self.label, k5=k5, k6=k6,
                           dispatches=self.tally.n, wall_s=self.wall,
                           output_tok_s=out_tokens / self.wall,
                           outputs=[s.output_ids for s in seqs],
                           **latency(seqs))
        return self.record

    def per_replica(self):
        """Requests, tok/s and latency of each replica id, by where each
        request finished."""
        per = {}
        for rid in sorted(self.fleet.replicas):
            mine = [self.done[f] for f in self.frids
                    if self.fleet.requests[f].replica_id == rid]
            per[rid] = dict(requests=len(mine),
                            tok_s=sum(len(s.output) for s in mine)
                            / self.wall, **latency(mine))
        return per

    def step_ms(self, live, kind=None):
        return step_stats([m for m, n, k in self.steps
                           if n == live and kind in (None, k)])


def step_stats(ms):
    """Median, mean and count of fleet-step wall times (ms)."""
    return dict(median=float(np.median(ms)) if ms else None,
                mean=float(np.mean(ms)) if ms else None, steps=len(ms))


def phase_fleet_serving(model, knobs, card):
    """Phase 7g, the fleet at full Llama-2-7B in bf16 (block 16, 8 slots,
    prefill chunk 128), every replica over the one model with a pool of
    its own (512 blocks, 4 GiB): (i) a monolithic 2-replica fleet on
    bench.py fleet's on-chip mix against one engine; (ii) the same with
    the seed wave in one burst and replica 1 killed at its ninth step and
    healed (card memory back within a block of its level before the
    death, no cycle collector);
    (iii) a 1:1 prefill/decode fleet on the first 16 requests; (iv)
    bench.py fleet ramp's on-chip profile with the autoscaler and
    migration on, one busy replica retired mid-burst with no drain
    budget; (v) a replica hung past a 5 s step budget while both step on
    threads of their own (the first 16 requests, the seed wave a burst);
    (vi) two replicas stepped inline and on threads on the same 16
    requests, fleet steps timed by kind.
    Zero loss and exact launches in every run.
    Returns the runs' records."""
    from paddle_tpu_torch import telemetry
    from paddle_tpu_torch.serving.fleet import EngineReplica, FleetRouter

    t_start = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    vocab = model.config.vocab_size
    tally = DispatchTally()
    kw = dict(knobs, pool_blocks=FLEET_POOL_BLOCKS)
    factory = tally.factory(model, **kw)
    block_bytes = (2 * LLAMA_LAYERS * knobs["block_size"]
                   * model.config.num_key_value_heads
                   * (model.config.hidden_size
                      // model.config.num_attention_heads) * 2)
    pool_bytes = FLEET_POOL_BLOCKS * block_bytes
    free, total = torch.cuda.mem_get_info()
    log(f"[serve:7g] bytes: weights={base} + pools of {pool_bytes} "
        f"({FLEET_POOL_BLOCKS} blocks of {block_bytes}) a replica, at most "
        f"4 live (iv) = {base + 4 * pool_bytes}; mem_get_info free={free} "
        f"total={total} ({card})")
    check(4 * pool_bytes < free, "7g: four pools do not fit the card")
    prompts, arrivals = fleet_mix(vocab)
    # bench.py's burst-mode seed wave (bench.py:1581-1586): the four seed
    # requests arrive together, so the least-delay ties spread them (and
    # their prefixes) over both replicas. Under the Poisson arrivals each
    # seed is scheduled before the next arrives, every tie goes to
    # replica 0, and affinity then keeps every later request there: (i)
    # shows it; (ii) and (v) need replica 1 to serve
    seeded = [0.0] * 4 + arrivals[4:]
    runs = {}

    # (i) monolithic, 2 replicas, against one engine; the replicas a run
    # starts with are warmed as bench.py warms them
    def warmed(i):
        return warm_replica(factory(), 100 + i)

    fleet = FleetRouter([EngineReplica(i, warmed(i)) for i in range(2)],
                        engine_factory=factory)
    r = FleetRun(fleet, tally, "7g-fleet").run(prompts, arrivals, 64)
    runs["7g-fleet"] = r.finish(64)
    per = r.per_replica()
    inline_ms = r.step_ms(2)
    log(f"[serve:7g-fleet] requests=32 {run_fields(runs['7g-fleet'])} "
        f"routed={fleet.routed} per_replica={per} inline fleet step ms="
        f"{inline_ms} ({card})")
    check(sum(p["requests"] for p in per.values()) == 32
          and fleet.routed["affinity"] > 0 and not fleet.deaths,
          f"7g (i): per-replica {per}, routed {fleet.routed}")
    fleet_pools_clean(fleet, "7g (i)")
    del fleet, r

    engine = warmed(0)
    tally.zero()
    single = {"done": {}, "rids": []}

    def submit_one(i, at):
        single["rids"].append(engine.add_request(prompts[i],
                                                 max_new_tokens=64,
                                                 arrival_s=at))

    def step_one():
        single["done"].update({s.req_id: s for s in engine.step()})

    t = time.perf_counter()
    replay(submit_one, step_one, engine.has_work, arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    k5, k6 = tally.check("7g-single", LLAMA_LAYERS)
    seqs = [single["done"][i] for i in single["rids"]]
    check(all(s.outcome == "ok" for s in seqs), "7g single: an outcome "
          "other than ok")
    runs["7g-single"] = dict(label="7g-single", k5=k5, k6=k6,
                             dispatches=tally.n, wall_s=wall,
                             output_tok_s=32 * 64 / wall,
                             outputs=[s.output_ids for s in seqs],
                             **latency(seqs))
    div = first_divergence(runs["7g-fleet"]["outputs"],
                           runs["7g-single"]["outputs"])
    log(f"[serve:7g-single] requests=32 {run_fields(runs['7g-single'])} "
        f"first differing token, fleet against one engine (-1: equal): "
        f"{div} ({card})")
    del engine, single, seqs

    # (ii) death and heal
    with port_flags(fault_spec="serving.fleet.replica:key=1:after=8:times=1",
                    telemetry=True, **FLEET_HEAL):
        telemetry.reset_all()
        fleet = FleetRouter([EngineReplica(i, warmed(i)) for i in range(2)],
                            engine_factory=factory)
        r = FleetRun(fleet, tally, "7g-heal")
        heal = {}

        def watch():
            from paddle_tpu_torch.serving.robustness import now_s
            if fleet.deaths and "death_s" not in heal:
                heal["death_s"], heal["mem_before"] = now_s(), heal["pre"]
            rep = fleet.replicas.get(1)
            if ("death_s" in heal and "promoted_s" not in heal
                    and fleet.respawns and rep is not None
                    and not rep.dead and not rep.joining):
                torch.cuda.synchronize()
                heal["promoted_s"] = now_s()
                heal["mem_after"] = torch.cuda.memory_allocated()
            heal["pre"] = torch.cuda.memory_allocated()

        heal["pre"] = torch.cuda.memory_allocated()
        r.hooks.append(watch)
        r.run(prompts, seeded, 64)
        t = time.perf_counter()
        while "promoted_s" not in heal and time.perf_counter() - t < 60.0:
            r.step()
        dump = telemetry.flight().dump_for("replica_death")
        runs["7g-heal"] = r.finish(64)
        telemetry.reset_all()
    check(fleet.deaths == [1] and fleet.respawns == 1
          and "promoted_s" in heal,
          f"7g (ii): deaths {fleet.deaths}, respawns {fleet.respawns}, "
          f"heal {heal}")
    extra = dump["extra"] if dump else {}
    mem_delta = heal["mem_after"] - heal["mem_before"]
    div = first_divergence(runs["7g-heal"]["outputs"],
                           runs["7g-fleet"]["outputs"])
    log(f"[serve:7g-heal] deaths={fleet.deaths} respawns={fleet.respawns} "
        f"routed={fleet.routed} per_replica={r.per_replica()} respawn_s "
        f"(death to promotion)={heal['promoted_s'] - heal['death_s']} "
        f"memory_allocated before the death={heal['mem_before']} after the "
        f"promotion={heal['mem_after']} delta={mem_delta} (one block="
        f"{block_bytes}) dump in_flight_rids={extra.get('in_flight_rids')} "
        f"fleet_rids={extra.get('fleet_rids')} {run_fields(runs['7g-heal'])}"
        f" first differing token against (i) (-1: equal): {div} ({card})")
    check(extra.get("replica") == 1 and extra.get("in_flight_rids"),
          "7g (ii): the death dump names no in-flight request")
    check(abs(mem_delta) <= block_bytes, f"7g (ii): card memory moved by "
          f"{mem_delta} bytes across the death and the respawn")
    del fleet, r

    # (iii) 1:1 prefill/decode on the first 16 requests
    with port_flags(telemetry=True):
        telemetry.reset_all()
        fleet = FleetRouter([EngineReplica(i, warmed(i), role=role)
                             for i, role in enumerate(("prefill",
                                                       "decode"))],
                            engine_factory=factory)
        fleet._disagg = timed = TimedHandoffs(fleet._disagg)
        r = FleetRun(fleet, tally, "7g-split").run(prompts[:16],
                                                   arrivals[:16], 64)
        runs["7g-split"] = r.finish(64)
        snap = telemetry.snapshot()
        ho_bytes = sum(s["value"] for s in snap.get(
            "serving_handoff_bytes_total", {}).get("samples", []))
        telemetry.reset_all()
    ledger = fleet._disagg.ledger.counts()
    dec = fleet.replicas[1].engine.metrics.snapshot()
    div = first_divergence(runs["7g-split"]["outputs"],
                           runs["7g-fleet"]["outputs"][:16])
    log(f"[serve:7g-split] ledger={ledger} handoff bytes={ho_bytes} "
        f"({ho_bytes / 16} a request) ms a handoff="
        f"{timed.seconds * 1e3 / max(1, ledger['committed'])} decode-role "
        f"tpot_p50_s={dec['tpot_p50_s']} tpot_p95_s={dec['tpot_p95_s']} "
        f"fleet {run_fields(runs['7g-split'])} first differing token "
        f"against (i) (-1: equal; bf16 in another dispatch shape may round "
        f"apart, phase 6 holds the f32 tokens equal): {div} ({card})")
    check(ledger == {"pending": 0, "begun": 16, "committed": 16,
                     "aborted": 0}
          and fleet.replicas[0].engine.health()["handoffs"]["out"] == 16,
          f"7g (iii): ledger {ledger}")
    del fleet, r, timed

    # (iv) autoscale with migration
    ramp_prompts, ramp_arrivals = ramp_mix(vocab)
    with port_flags(telemetry=True, serving_drain_timeout_s=0.0,
                    **RAMP_FLAGS):
        telemetry.reset_all()
        fleet = FleetRouter([EngineReplica(0, warmed(0))],
                            engine_factory=factory)
        fleet.enable_autoscale()
        r = FleetRun(fleet, tally, "7g-ramp")
        forced = {}

        def force_retire():
            # bench.py fleet ramp --migrate (bench.py:1895-1916): retire
            # the busiest replica once, with stragglers to move, as soon
            # as it has a SERVING peer
            if forced or len(fleet._live()) < 2:
                return
            cands = [x for x in fleet.replicas.values()
                     if not x.dead and not x.joining and not x.retiring]

            def busy(x):
                return sum(1 for s in x.engine.requests.values()
                           if s.ctx >= 1)
            victim = max(cands, key=busy, default=None)
            peers = [x for x in cands if x is not victim
                     and x.engine.lifecycle.state == "serving"]
            if victim is not None and busy(victim) >= 2 and peers:
                forced["replica"] = victim.replica_id
                forced["ok"] = fleet.scale_down(victim.replica_id,
                                                reason="forced")

        r.hooks.append(force_retire)
        r.run(ramp_prompts, ramp_arrivals, RAMP_NEW, always_step=True)
        # the idle tail: the fleet scales back to its floor
        t = time.perf_counter()
        while ((len(fleet._live()) > 1 or fleet.health()["retiring"])
               and time.perf_counter() - t < 30.0):
            r.step()
            time.sleep(0.005)
        snap = telemetry.snapshot()
        runs["7g-ramp"] = r.finish(RAMP_NEW)
        telemetry.reset_all()

    def counter(name):
        return sum(s["value"] for s in snap.get(name, {}).get("samples", []))
    dirs = [e["direction"] for e in fleet.scale_events]
    events = [(e["direction"], e["replica"], round(e["t_s"] - r.t0, 3),
               e["reason"]) for e in fleet.scale_events]
    log(f"[serve:7g-ramp] requests={len(ramp_prompts)} scale events "
        f"(direction, replica, t_s, reason)={events} forced={forced} "
        f"migrations={counter('serving_fleet_migrations_total')} migrated "
        f"bytes={counter('serving_migrate_bytes_total')} ledger="
        f"{fleet._migrate.ledger.counts()} respawns={fleet.respawns} "
        f"final live={len(fleet._live())} {run_fields(runs['7g-ramp'])} "
        f"({card})")
    check("up" in dirs and "down" in dirs, f"7g (iv): scale events {dirs}")
    check(counter("serving_fleet_migrations_total") > 0,
          "7g (iv): no request migrated")
    del fleet, r

    # (v) a hung replica under a 5 s budget: both replicas step on threads
    # of their own
    with port_flags(fault_spec="serving.fleet.replica_hang:key=1:after=4:"
                    "sleep=8:times=1", serving_fleet_step_timeout_s=5.0):
        fleet = FleetRouter([EngineReplica(i, warmed(i)) for i in range(2)])
        # each replica's worker thread starts on a readiness probe, so the
        # timed steps leave out its first calls (cuBLAS's set-up on a new
        # thread)
        for rid in sorted(fleet.replicas):
            check(probe_on_worker(fleet.replicas[rid]),
                  "7g (v): a readiness probe failed")
        workers = [fleet.replicas[1]._worker]
        r = FleetRun(fleet, tally, "7g-hang")
        r.run(prompts[:16], seeded[:16], 64)
        runs["7g-hang"] = r.finish(64, workers)
    threaded_ms = r.step_ms(2)
    slow = [m for m, _, _ in r.steps if m > 4000.0]
    log(f"[serve:7g-hang] deaths={fleet.deaths} hangs={fleet.hangs} "
        f"death_reason={fleet.replicas[1].death_reason!r} steps over the "
        f"budget (ms)={slow} threaded fleet step ms (2 live)={threaded_ms} "
        f"(1 live)={r.step_ms(1)} against inline in (i)={inline_ms} "
        f"{run_fields(runs['7g-hang'])} ({card})")
    check(fleet.hangs == 1 and fleet.deaths == [1],
          f"7g (v): hangs {fleet.hangs}, deaths {fleet.deaths}")
    del fleet, r, workers

    # (vi) inline against threaded on the same steps: the first 16
    # requests in one burst, 32 new tokens, two warmed replicas stepped
    # inline (no budget) or each on its worker thread (a budget no step
    # reaches), inline then threaded (cut from inline, threaded,
    # threaded, inline to keep the run inside half its time limit); fleet
    # steps split by kind, both replicas live throughout
    by_mode = {"inline": [], "threaded": []}
    for mode in ("inline", "threaded"):
        budget = 30.0 if mode == "threaded" else 0.0
        label = f"7g-{mode}"
        with port_flags(serving_fleet_step_timeout_s=budget):
            fleet = FleetRouter([EngineReplica(j, warmed(j))
                                 for j in range(2)])
            if mode == "threaded":
                for rid in sorted(fleet.replicas):
                    check(probe_on_worker(fleet.replicas[rid]),
                          f"{label}: a readiness probe failed")
            r = FleetRun(fleet, tally, label).run(prompts[:16], [0.0] * 16,
                                                  32)
            runs[label] = r.finish(32)
        check(not fleet.deaths and not fleet.hangs,
              f"{label}: deaths {fleet.deaths}, hangs {fleet.hangs}")
        by_mode[mode].extend(r.steps)
        log(f"[serve:7g-{mode}] run={label} per_replica={r.per_replica()} "
            f"step ms (2 live) prefill={r.step_ms(2, 'prefill')} decode="
            f"{r.step_ms(2, 'decode')} {run_fields(runs[label])} ({card})")
        del fleet, r
    split = {mode: {kind: step_stats([m for m, n, k in steps
                                      if n == 2 and k == kind])
                    for kind in ("prefill", "decode")}
             for mode, steps in by_mode.items()}
    ratio = {kind: (split["threaded"][kind]["median"]
                    / split["inline"][kind]["median"]
                    if split["threaded"][kind]["steps"]
                    and split["inline"][kind]["steps"] else None)
             for kind in ("prefill", "decode")}
    log(f"[serve:7g-steps] fleet step wall ms, 2 live, both runs of each "
        f"mode on the same 16-request burst: {split} median threaded/inline"
        f"={ratio} ({card})")
    check(all(split[m]["decode"]["steps"] for m in split),
          f"7g (vi): no decode step with both replicas live: {split}")
    del by_mode
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - base
    log(f"[serve:7g] seconds={time.perf_counter() - t_start} "
        f"memory_allocated above the weights after the fleets={left} "
        f"engines built={len(tally.built)} still alive (index, referrers)="
        f"{tally.alive()}")
    check(left < pool_bytes // 2, f"7g: {left} bytes still allocated after "
          f"every fleet was dropped")
    for rec in runs.values():
        rec.pop("outputs")
    return runs


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
    i, lab = (torch.tensor(a, device="cuda") for a in batch)
    for gran in ("full", "core_attn", "full_attn"):
        # per-layer recompute on the card against the CPU's plain step
        card.config.recompute = True
        card.config.recompute_granularity = gran
        for p in card.parameters():
            p.grad = None
        loss = llama_loss_fn(card, i, lab)
        loss.backward()
        err = abs(float(loss.detach()) - losses["cpu"]) / abs(losses["cpu"])
        check(err <= TRAIN_LOSS_RTOL, f"recompute={gran}: loss differs card "
              f"vs CPU")
        worst = ("", 0.0)
        for n, p in card.named_parameters():
            e = _max_rel_err(p.grad, host_params[n].grad)
            worst = max(worst, (n, e), key=lambda t: t[1])
            check(e <= TRAIN_GRAD_REL, f"recompute={gran}: gradient of {n} "
                  f"differs card vs CPU: {e} of its largest element")
        log(f"[train-parity] recompute={gran}: loss card="
            f"{float(loss.detach())} "
            f"rel_err={err}; all gradients within {TRAIN_GRAD_REL}; worst "
            f"{worst[0]} {worst[1]}")
    card.config.recompute = False
    for p in card.parameters():
        p.grad = None
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
    # 3 more steps under LinearWarmup over CosineAnnealingDecay with a
    # grad_postprocess that halves every gradient
    from paddle_tpu_torch.optimizer import lr as sched_lr

    traj, rates = {}, {}
    for dev, model in (("cuda", card), ("cpu", host)):
        i, lab = (torch.tensor(a, device=dev) for a in batch)
        sched = sched_lr.LinearWarmup(
            sched_lr.CosineAnnealingDecay(1e-6, T_max=3), warmup_steps=1,
            start_lr=2e-7, end_lr=1e-6)
        step = TrainStep(model, AdamW(learning_rate=sched), llama_loss_fn,
                         grad_postprocess=lambda g: {n: v * 0.5
                                                     for n, v in g.items()})
        traj[dev], rates[dev] = [], []
        for _ in range(3):
            rates[dev].append(step.optimizer.get_lr())
            traj[dev].append(float(step(i, lab)))
            sched.step()
    rel = [abs(a - b) / abs(b) for a, b in zip(traj["cuda"], traj["cpu"])]
    log(f"[train-parity] 3 AdamW steps, LinearWarmup over "
        f"CosineAnnealingDecay (rates {rates['cuda']}), grad_postprocess "
        f"halving: card={traj['cuda']} cpu={traj['cpu']} rel_err={rel} tol "
        f"{TRAIN_TRAJ_RTOL} seconds={time.perf_counter() - t0}")
    check(rates["cuda"] == rates["cpu"] and len(set(rates["cuda"])) == 3,
          "the schedule did not move the rate")
    check(max(rel) <= TRAIN_TRAJ_RTOL, "scheduled loss trajectory differs "
          "card vs CPU")
    del card, host
    torch.cuda.empty_cache()


# -- phase 9: training at full width ------------------------------------------

TRAIN_FAMILIES = (("flash_fwd", ("flash_fwd_kernel",)),
                  ("flash_dq", ("flash_dq_kernel",)),
                  ("flash_dkv", ("flash_dkv_kernel",)),
                  ("k6_rms_norm", ("rms_norm_fwd",)),
                  ("matmul", ("nvjet", "gemm", "cutlass", "xmma")))


def _train_wrappers():
    from paddle_tpu_torch.ops.hopper import flash_attention as fa
    from paddle_tpu_torch.ops.hopper.rms_norm import rms_norm_cuda

    return dict(fwd=fa.flash_attention_fwd_cuda,
                dq=fa.flash_attention_dq_cuda,
                dkv=fa.flash_attention_dkv_cuda, k6=rms_norm_cuda)


def _train_counts():
    """The flash and K6 launches since the last reset, by kernel and by
    form: ``{"fwd": {"torch.bfloat16/d128": n, ...}, ..., "k6":
    {"torch.float32": n}}`` (at head_dim 256 a dkv call is a dK and a dV
    launch)."""
    return {k: dict(fn.launches_by_form)
            for k, fn in _train_wrappers().items()}


def _reset_train_counts():
    from paddle_tpu_torch.ops.hopper._build import reset_launches

    reset_launches(*_train_wrappers().values())


def _totals(counts):
    """Launches by kernel, every form summed."""
    return {k: sum(by.values()) for k, by in counts.items()}


def _step_counts(before, after):
    """The launches by kernel and form between two :func:`_train_counts`."""
    return {k: {f: n - before[k].get(f, 0) for f, n in after[k].items()
                if n - before[k].get(f, 0)} for k in after}


def phase_training(warmup=2, timed=5, recompute=False, plain=None):
    """Llama-2-7B widths (hidden 4096, intermediate 11008, 32 heads of
    128, vocab 32000) cut to 8 layers, bf16 with f32 AdamW masters, a
    fixed random batch of 2 x 4096 tokens, as bench.py's 7B-layer bench
    runs it. Every step must launch exactly 8 flash forward, 8 dq and 8
    dkv kernels and 17 K6 forwards; the loss must stay finite and fall.

    With ``recompute`` (granularity ``full``), the same steps from the
    same weights: 16 flash forwards (each layer's forward runs again in
    the backward), 8 dq, 8 dkv and 33 K6 forwards a step; each step's
    loss equal to ``plain``'s (the run without recompute: bitwise, or
    else within phase 8's trajectory tolerance, logged as which); a lower
    peak memory; no profile window. Returns the launch counts with the
    losses, step ms and peak memory."""
    from paddle_tpu_torch import (LlamaConfig, LlamaForCausalLM, TrainStep,
                                  llama_loss_fn)
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.reset_peak_memory_stats()
    mem_base = torch.cuda.memory_allocated()
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=TRAIN_LAYERS,
                                fused_head_loss=True, dtype="bfloat16",
                                recompute=recompute)
    model = LlamaForCausalLM(cfg, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    mem_weights = torch.cuda.memory_allocated()
    step = TrainStep(model, AdamW(learning_rate=1e-4, multi_precision=True),
                     llama_loss_fn)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                        device="cuda", generator=gen)
    ids, labels = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    again = 2 if recompute else 1
    want = dict(fwd=again * TRAIN_LAYERS, dq=TRAIN_LAYERS, dkv=TRAIN_LAYERS,
                k6=again * 2 * TRAIN_LAYERS + 1)
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
        got = _totals(_step_counts(before, _train_counts()))
        check(got == want, f"training step {i}: launches {got} != {want}")
    counts = _train_counts()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_s = sum(seconds[warmup:]) / timed
    tok_s = tokens / step_s
    mfu = 6 * n_params * tok_s / PEAK_OPS_S[torch.bfloat16]
    log(f"[train] llama2_7b widths, {TRAIN_LAYERS} layers, bf16, AdamW "
        f"multi_precision, batch {TRAIN_BATCH}x{TRAIN_SEQ}, recompute="
        f"{recompute}: params={n_params} losses={losses}")
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
    peak = torch.cuda.max_memory_allocated()
    if plain is None:
        profile_train_window(step, (ids, labels), step_s * 1e3)
    else:
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain["losses"])]
        bitwise = losses == plain["losses"]
        log(f"[train] recompute=full against the plain step: losses "
            f"{'bitwise equal' if bitwise else 'not bitwise equal'}, "
            f"rel_err={rel} (tol {TRAIN_TRAJ_RTOL}); peak_memory_bytes "
            f"{peak} against {plain['peak']} (x{peak / plain['peak']}); "
            f"step_ms {step_s * 1e3} against {plain['step_ms']} "
            f"(x{step_s * 1e3 / plain['step_ms']}); tokens_per_s {tok_s} "
            f"against {tokens / plain['step_ms'] * 1e3}")
        check(bitwise or max(rel) <= TRAIN_TRAJ_RTOL, "recompute: the "
              "losses differ from the plain step's")
        check(peak < plain["peak"], "recompute: peak memory is not below "
              "the plain step's")
    del model, step
    torch.cuda.empty_cache()
    return dict(_totals(counts), forms=counts, losses=losses, peak=peak,
                step_ms=step_s * 1e3)


def profile_train_window(step, batch, wall_ms, steps=2, label="train",
                         families=TRAIN_FAMILIES):
    """Device time per training step by kernel family (``families``)
    under torch.profiler, and the device's idle share against the
    unprofiled step time ``wall_ms``. Returns (device ms by family, idle
    share)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(*batch)
        torch.cuda.synchronize()
    others, ranges = {}, {}
    device_ms = device_ms_by_family(prof, families, steps, others, ranges)
    busy_ms = sum(device_ms.values())
    log(f"[{label}-profile] per step: wall_ms={wall_ms} (unprofiled) "
        f"device_busy_ms={busy_ms} device_idle_share={1 - busy_ms / wall_ms}"
        f" ({steps} profiled steps)")
    log(f"[{label}-profile] device_ms_per_step_by_family="
        f"{json.dumps(device_ms)}")
    log(f"[{label}-profile] device span per step of the TrainStep ranges: "
        f"{json.dumps(ranges)}")
    top = sorted(others.items(), key=lambda kv: -kv[1])[:10]
    log(f"[{label}-profile] largest of other, ms per step: "
        f"{json.dumps([(k[:90], v) for k, v in top])}")
    return device_ms, 1 - busy_ms / wall_ms


# -- phase 13: the transformer families beside Llama -------------------------

# the three families' attention at their training shapes (name, dtype, b,
# sq, sk, h, kv, d, causal): BERT-base at bench_bert's batch 64 x 512 cut
# to 32 (the plain backward's f32 scores), DiT-XL/2 at batch 32 (head_dim
# 72: zero-padded to 128), GPT-2 small at batch 8 x 1024
FAMILY_FLASH_CASES = [
    ("bert_noncausal_b32_s512_h12_d64_bf16", torch.bfloat16, 32, 512, 512,
     12, 12, 64, False),
    ("dit_xl2_noncausal_b32_s256_h16_d72_bf16", torch.bfloat16, 32, 256, 256,
     16, 16, 72, False),
    ("gpt_causal_b8_s1024_h12_d64_bf16", torch.bfloat16, 8, 1024, 1024, 12,
     12, 64, True),
]
# GPT-2 small (GPTConfig()): 12 layers; quantized, 4 int8 linears a layer
# (qkv, out, fc_in, fc_out) and the head dense
GPT_LAYERS = 12
GPT_INT8_PER_DISPATCH = 4 * GPT_LAYERS
# K10 at GPT-2 small's four linear shapes (name, K, N), with a decode step
# of 8 slots and a 128-token prefill chunk
GPT_INT8_SHAPES = (("768x2304", 768, 2304), ("768x768", 768, 768),
                   ("768x3072", 768, 3072), ("3072x768", 3072, 768))
GPT_INT8_ROWS = (8, 128)
# the first batch of each list that fits: bench_bert's TPU candidates at
# seq 512, bench_dit's
BERT_BATCHES, BERT_SEQ = (64, 48, 32, 16), 512
DIT_BATCHES = (32, 16, 8)
GPT_TRAIN_BATCH, GPT_TRAIN_SEQ = 8, 1024


def time_flash_case(q, k, v, do, out, lse, causal, scale):
    """Times of one flash case by CUDA events: the wrappers as the model
    calls them (forward; whole backward with delta, and the zero padding
    at a padded head_dim), the kernels alone at the width they run
    (``*_kernel_ms``, dq and dkv apart), the plain versions, SDPA's
    forward and backward, and each kernel's bound at the true head_dim
    (:func:`flash_bound`)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    d = q.shape[-1]
    width = fa.padded_head_dim(d)
    qp, kp, vp, dop, outp = (fa.pad_head_dim(t, width)
                             for t in (q, k, v, do, out))
    delta = (dop.float() * outp.float()).sum(-1).transpose(1, 2).contiguous()
    bwd_args = (qp, kp, vp, dop, lse, delta, causal, scale)
    r = dict(
        fwd_ms=time_ms(lambda: fa.flash_attention_fwd_cuda(q, k, v, causal,
                                                           scale)),
        bwd_ms=time_ms(lambda: fa.flash_attention_bwd_cuda(
            q, k, v, out, lse, do, causal, scale)),
        fwd_kernel_ms=time_ms(lambda: fa.flash_attention_fwd_cuda(
            qp, kp, vp, causal, scale)),
        dq_kernel_ms=time_ms(lambda: fa.flash_attention_dq_cuda(*bwd_args)),
        dkv_kernel_ms=time_ms(lambda: fa.flash_attention_dkv_cuda(
            *bwd_args)),
        plain_fwd_ms=time_ms(lambda: fa.flash_attention_fwd_reference(
            q, k, v, causal, scale), iters=2, warmup=1),
        plain_bwd_ms=time_ms(lambda: fa.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal, scale), iters=2, warmup=1))
    del qp, kp, vp, dop, outp, delta, bwd_args
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    r["library_fwd_ms"] = time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                               scale=scale))
    lib_out = sdpa(qt, kt, vt, is_causal=causal, scale=scale)
    r["library_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True))
    m = dict(q=q, k=k, causal=causal)
    for kernel in ("fwd", "dq", "dkv"):
        r[f"{kernel}_bound_ms"], r[f"{kernel}_bound_by"] = flash_bound(
            m, kernel)
    return r


def phase_family_flash():
    """Phase 13a: K1-K4 at the three families' attention shapes, each
    through :func:`flash_check` (out, lse, dq, dk, dv against the plain
    versions, row by row, equal bits over two backward calls) and timed
    (:func:`time_flash_case`); the padded head_dim 72 is also timed at
    d = 64 on the same batch and heads, the time a native 72-wide tile
    would stay above. Returns {case: errors and times}."""
    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1913)
    results = {}
    for name, dt, b, sq, sk, h, kv, d, causal in FAMILY_FLASH_CASES:
        def rnd(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(dt)

        q, k, v = rnd(b, sq, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d)
        do = rnd(b, sq, h, d)
        scale = 1.0 / d ** 0.5
        errs, out, lse = flash_check(name, q, k, v, do, causal, scale)
        r = dict(errs, **time_flash_case(q, k, v, do, out, lse, causal,
                                         scale))
        del q, k, v, do, out, lse
        if d != 64:
            q64, k64, v64, do64 = (rnd(b, sq, h, 64) for _ in range(4))
            out64, lse64 = fa.flash_attention_fwd_cuda(q64, k64, v64, causal,
                                                       0.125)
            r["d64_fwd_ms"] = time_ms(lambda: fa.flash_attention_fwd_cuda(
                q64, k64, v64, causal, 0.125))
            r["d64_bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd_cuda(
                q64, k64, v64, out64, lse64, do64, causal, 0.125))
            del q64, k64, v64, do64, out64, lse64
        log(f"[family-flash] {name} "
            + " ".join(f"{key}={val}" for key, val in r.items()))
        results[name] = r
        torch.cuda.empty_cache()
    return results


def phase_gpt_kernels():
    """Phase 13b: K5 at GPT-2 small's decode (8 slots, 12 heads of 64,
    MHA, at phase 7's depths) and K10 at its four linear shapes (8 and
    128 rows in bf16, 8 in f32), each against its plain version (K10
    twice, for equal bits) and timed as phases 5 and 5b time them.
    Returns (K5 result, K10 times)."""
    from paddle_tpu_torch.ops.hopper import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(1914)
    c = k5_case(gen, b=8, s=1, h=12, kv=12, d=64, bs=16,
                max_blocks=1024 // 16, positions=serving_depths())
    args = (c["q"], c["kbuf"], c["vbuf"], c["tables"], c["positions"])
    kw = dict(kv_heads=12, head_dim=64)
    got = pa.paged_attend_cuda(*args, **kw)
    want = pa.paged_attend_reference(*args, **kw)
    torch.cuda.synchronize()
    k5 = dict(case=c, args=args, kw=kw, max_err=k5_check(
        "gpt_decode_b8_h12_d64", got, want))
    check(torch.equal(got, pa.paged_attend_cuda(*args, **kw)),
          "K5 gpt_decode_b8_h12_d64: two calls differ")
    results = {"gpt_decode_b8_h12_d64": k5}
    time_k5(results)
    matmul = torch.backends.cuda.matmul
    before = (matmul.allow_bf16_reduced_precision_reduction,
              matmul.allow_tf32)
    matmul.allow_bf16_reduced_precision_reduction = False
    matmul.allow_tf32 = False
    cases = {}
    try:
        for sh, kk, n in GPT_INT8_SHAPES:
            q, sc = k10_inputs(gen, kk, n)
            for m, dt in [(m, torch.bfloat16) for m in GPT_INT8_ROWS] + [
                    (8, torch.float32)]:
                x = torch.randn(m, kk, device="cuda", generator=gen).to(dt)
                name = f"gpt_{sh}_m{m}_{str(dt).split('.')[-1]}"
                err, failure = k10_check(name, x, q, sc)
                check(failure is None, failure)
                cases[name] = dict(x=x, q=q, s=sc, max_err=err,
                                   timed=dt == torch.bfloat16)
    finally:
        (matmul.allow_bf16_reduced_precision_reduction,
         matmul.allow_tf32) = before
    k10 = time_k10(cases)
    del cases
    torch.cuda.empty_cache()
    return results["gpt_decode_b8_h12_d64"], k10


def phase_gpt_serving(card):
    """Phase 13c: GPT-2 small (``GPTConfig()``: vocab 50304, 768 wide, 12
    layers, 12 heads, 1024 positions; random weights from seed 0). In f32
    (TF32 off): the default engine's greedy tokens on phase 6's prompts
    equal dense ``generate``'s; then the model quantized in place by
    ``quantize_for_decode`` (the head dense): tokens equal again and K10
    launches exact (48 a dispatch). In bf16: phase 7's mix (8 requests of
    128-512 tokens, 64 new; block 16, 8 slots, chunk 128) through
    ``ServingEngine.from_model``, then the same model quantized: zero
    loss, exact launches (K5 12, K6 0, K10 0 or 48 a dispatch), tok/s,
    TTFT, TPOT. Returns the two bf16 runs."""
    from paddle_tpu_torch import (GPTConfig, GPTForCausalLM, ServingEngine,
                                  quantize_for_decode)
    from paddle_tpu_torch.ops.hopper.int8_matmul import int8_matmul_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    cfg = GPTConfig()
    model = GPTForCausalLM(cfg, seed=0)
    check(serving_geometry(model) == (GPT_LAYERS, 12, 64),
          "GPT-2 small's geometry")
    prompts = phase6_prompts(cfg.vocab_size)
    engine = ServingEngine.from_model(model)
    _check_greedy(model, "gpt f32", prompts,
                  _engine_outputs(engine, prompts, 8), 8)
    del engine
    quantize_for_decode(model)
    n_int8 = sum(p.dtype == torch.int8 for p in model.parameters())
    check(n_int8 == GPT_INT8_PER_DISPATCH and
          model.lm_head.dtype == torch.float32,
          f"GPT quantized: {n_int8} int8 weights (want "
          f"{GPT_INT8_PER_DISPATCH}) and the head {model.lm_head.dtype}")
    engine = ServingEngine.from_model(model)
    int8_matmul_cuda.launches = 0
    out = _engine_outputs(engine, prompts, 8)
    k10 = int8_matmul_cuda.launches
    check(k10 == GPT_INT8_PER_DISPATCH * engine.dispatches,
          f"GPT int8: K10 launches {k10} != {GPT_INT8_PER_DISPATCH} x "
          f"{engine.dispatches} dispatches")
    _check_greedy(model, "gpt int8 f32", prompts, out, 8)
    log(f"[gpt-serve] f32, 12 layers: engine tokens equal dense generate, "
        f"dense and quantized (K10 {k10} = {GPT_INT8_PER_DISPATCH} x "
        f"{engine.dispatches} dispatches); seconds="
        f"{time.perf_counter() - t0}")
    del engine, model
    release_device_memory()

    t0 = time.perf_counter()
    model = GPTForCausalLM(GPTConfig(dtype="bfloat16"), seed=0)
    knobs = dict(block_size=16, max_slots=8, prefill_chunk=128)
    mix = phase7_mix(cfg.vocab_size)
    runs = {}
    for label in ("gpt-bf16", "gpt-int8"):
        if label == "gpt-int8":
            quantize_for_decode(model)
        warm_serving(model, knobs)
        engine = ServingEngine.from_model(model, **knobs)
        runs[label] = serve_run(
            engine, label, mix, 64, layers=GPT_LAYERS, rms_norms=False,
            k10_per_dispatch=GPT_INT8_PER_DISPATCH * (label == "gpt-int8"))
        del engine
        release_device_memory()
    b, q = runs["gpt-bf16"], runs["gpt-int8"]
    for label, r in runs.items():
        log(f"[gpt-serve:{label}] tok_s={r['output_tok_s']} ttft_p50_s="
            f"{r['ttft_p50_s']} ttft_p95_s={r['ttft_p95_s']} tpot_p50_s="
            f"{r['tpot_p50_s']} tpot_p95_s={r['tpot_p95_s']} k5={r['k5']} "
            f"k10={r['k10']} dispatches={r['dispatches']} peak_memory_bytes="
            f"{r['peak_memory_bytes']} ({card})")
    log(f"[gpt-serve] int8/bf16 tok_s x{q['output_tok_s'] / b['output_tok_s']}"
        f"; first differing token per request: "
        f"{first_divergence(q['outputs'], b['outputs'])}; seconds="
        f"{time.perf_counter() - t0} ({card})")
    del model
    release_device_memory()
    check_released("phase 13c", base)
    return runs


def _family_model(family, layers, dtype, device=None, seed=0):
    """GPT-2 small, BERT-base (fused MLM head) or DiT-XL/2 at full width,
    cut to ``layers`` when given."""
    import paddle_tpu_torch as tpt

    if family == "gpt":
        kw = {} if layers is None else dict(num_hidden_layers=layers)
        return tpt.GPTForCausalLM(tpt.GPTConfig(dtype=dtype, **kw),
                                  device=device, seed=seed)
    if family == "bert":
        kw = {} if layers is None else dict(num_hidden_layers=layers)
        return tpt.BertForPretraining(
            tpt.BertConfig(fused_head_loss=True, dtype=dtype, **kw),
            device=device, seed=seed)
    kw = {} if layers is None else dict(depth=layers)
    return tpt.DiT(tpt.DiTConfig(dtype=dtype, **kw), device=device,
                   seed=seed)


def _family_batch(family, batch, vocab, device, seed=0):
    """A fixed random batch: GPT ids and next-token labels; BERT ids and
    labels (a label below zero in 85 of 100 positions: not masked, so
    ignored); DiT latents, timesteps, classes and a noise target."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if family == "gpt":
        ids = torch.randint(0, vocab, (batch[0], batch[1] + 1),
                            device=device, generator=gen)
        return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
    if family == "bert":
        ids = torch.randint(0, vocab, batch, device=device, generator=gen)
        labels = torch.randint(0, vocab, batch, device=device, generator=gen)
        keep = torch.rand(batch, device=device, generator=gen) < 0.15
        return ids, torch.where(keep, labels, torch.full_like(labels, -1))
    b = batch[0]
    x = torch.randn(b, 4, 32, 32, device=device, generator=gen)
    t = torch.randint(0, 1000, (b,), device=device, generator=gen)
    y = torch.randint(0, 1000, (b,), device=device, generator=gen)
    tgt = torch.randn(b, 4, 32, 32, device=device, generator=gen)
    return x, t, y, tgt


def _family_cfg(model):
    """The config of a GPT (``model.gpt.cfg``), BERT or DiT
    (``model.cfg``)."""
    return model.gpt.cfg if hasattr(model, "gpt") else model.cfg


def _family_loss_fn(family):
    import paddle_tpu_torch as tpt

    return tpt.dit_loss_fn if family == "dit" else tpt.llama_loss_fn


def _noisy_dit(model, seed):
    """Every parameter of a DiT redrawn from N(0, 0.02) (LayerNorm
    weights 1 + that): the adaLN-zero and final projections start at
    zero, which would hide the blocks from a gradient check."""
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, device=p.device, generator=gen)
            one = name.endswith("norm1.weight") or name.endswith(
                "norm2.weight") or name == "final_norm.weight"
            p.copy_(0.02 * noise + (1.0 if one else 0.0))


def phase_family_train_parity():
    """Phase 13d: each family at full width, 2 layers, f32, TF32 off: one
    forward/backward on the card (flash kernels; DiT's head_dim 72
    zero-padded) against the CPU (plain versions) on the same weights
    (DiT's all redrawn non-zero), the loss to TRAIN_LOSS_RTOL and every
    gradient to TRAIN_GRAD_REL of its largest element; then 2 AdamW
    TrainSteps on each device, the losses to TRAIN_TRAJ_RTOL."""
    from paddle_tpu_torch import TrainStep, load_reference_state
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    shapes = dict(gpt=(1, 256), bert=(2, 128), dit=(2,))
    for family in ("gpt", "bert", "dit"):
        card = _family_model(family, 2, "float32")
        if family == "dit":
            _noisy_dit(card, 7)
        host = _family_model(family, 2, "float32", device="cpu", seed=1)
        load_reference_state(host, {n: p.detach().cpu().numpy()
                                    for n, p in card.named_parameters()})
        vocab = getattr(_family_cfg(card), "vocab_size", 0)
        batch = _family_batch(family, shapes[family], vocab, "cpu", seed=21)
        loss_fn = _family_loss_fn(family)
        losses = {}
        for dev, model in (("cuda", card), ("cpu", host)):
            loss = loss_fn(model, *(t.to(dev) for t in batch))
            loss.backward()
            losses[dev] = float(loss.detach())
        err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        check(err <= TRAIN_LOSS_RTOL, f"{family}: f32 loss differs card vs "
              f"CPU ({losses})")
        host_params = dict(host.named_parameters())
        worst = ("", 0.0)
        for n, p in card.named_parameters():
            if p.grad is None:
                # BERT's token-type table without token types
                check(host_params[n].grad is None, f"{family}: {n} has a "
                      f"gradient on the CPU only")
                continue
            e = _max_rel_err(p.grad, host_params[n].grad)
            worst = max(worst, (n, e), key=lambda x: x[1])
            check(e <= TRAIN_GRAD_REL, f"{family}: gradient of {n} differs "
                  f"card vs CPU: {e} of its largest element")
        for model in (card, host):
            for p in model.parameters():
                p.grad = None
        traj = {}
        for dev, model in (("cuda", card), ("cpu", host)):
            step = TrainStep(model, AdamW(learning_rate=1e-5), loss_fn)
            traj[dev] = [float(step(*(t.to(dev) for t in batch)))
                         for _ in range(2)]
        rel = [abs(a - b) / abs(b) for a, b in zip(traj["cuda"], traj["cpu"])]
        log(f"[family-parity] {family} full width, 2 layers, f32: loss card="
            f"{losses['cuda']} cpu={losses['cpu']} rel_err={err}; all "
            f"{len(host_params)} gradients within {TRAIN_GRAD_REL}, worst "
            f"{worst[0]} {worst[1]}; 2 AdamW steps card={traj['cuda']} cpu="
            f"{traj['cpu']} rel_err={rel}")
        check(max(rel) <= TRAIN_TRAJ_RTOL, f"{family}: f32 TrainStep losses "
              f"differ card vs CPU")
        del card, host, step
        torch.cuda.empty_cache()
    log(f"[family-parity] seconds={time.perf_counter() - t0}")


def train_family(family, card, warmup=2, timed=5):
    """Phase 13e: one family at full width and depth in bf16, AdamW with
    f32 masters (``multi_precision``), learning rate 1e-4, on a fixed
    random batch: GPT-2 small at 8 x 1024, BERT-base at seq 512 and the
    first of BERT_BATCHES that fits, DiT-XL/2 (32^2 latents, 256 tokens)
    at the first of DIT_BATCHES that fits. ``warmup`` + ``timed`` steps,
    each launching exactly one flash forward, one dq and one dkv kernel a
    layer and no K6; the loss finite and falling; step ms, tokens/s
    (samples/s for DiT), MFU by bench.py's formulas over 989 TFLOP/s,
    peak memory, then a torch.profiler window. Returns the numbers."""
    from paddle_tpu_torch import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    batches = dict(gpt=[(GPT_TRAIN_BATCH, GPT_TRAIN_SEQ)],
                   bert=[(b, BERT_SEQ) for b in BERT_BATCHES],
                   dit=[(b,) for b in DIT_BATCHES])[family]
    t0 = time.perf_counter()
    for shape in batches:
        torch.cuda.synchronize()
        release_device_memory()
        torch.cuda.reset_peak_memory_stats()
        model = _family_model(family, None, "bfloat16")
        cfg = _family_cfg(model)
        layers = getattr(cfg, "depth", None) or cfg.num_hidden_layers
        vocab = getattr(cfg, "vocab_size", 0)
        n_params = sum(p.numel() for p in model.parameters())
        step = TrainStep(model, AdamW(learning_rate=1e-4,
                                      multi_precision=True),
                         _family_loss_fn(family))
        batch = _family_batch(family, shape, vocab, "cuda")
        want = dict(fwd=layers, dq=layers, dkv=layers, k6=0)
        losses, seconds = [], []
        _reset_train_counts()
        try:
            for i in range(warmup + timed):
                before = _train_counts()
                torch.cuda.synchronize()
                ts = time.perf_counter()
                losses.append(float(step(*batch)))
                seconds.append(time.perf_counter() - ts)
                got = _totals(_step_counts(before, _train_counts()))
                check(got == want, f"{family} training step {i}: launches "
                      f"{got} != {want}")
        except torch.cuda.OutOfMemoryError:
            log(f"[family-train] {family} batch {shape}: out of memory, "
                f"trying the next")
            del model, step, batch
            continue
        break
    else:
        raise SmokeFailure(f"{family}: no batch of {batches} fits")
    counts = _train_counts()
    step_s = sum(seconds[warmup:]) / timed
    if family == "dit":
        tokens = (cfg.input_size // cfg.patch_size) ** 2
        rate, unit = shape[0] / step_s, "samples_per_s"
        mfu = 6 * n_params * tokens * rate / PEAK_OPS_S[torch.bfloat16]
    else:
        rate, unit = shape[0] * shape[1] / step_s, "tokens_per_s"
        mfu = 6 * n_params * rate / PEAK_OPS_S[torch.bfloat16]
    peak = torch.cuda.max_memory_allocated()
    log(f"[family-train] {family} full width, {layers} layers, bf16, AdamW "
        f"multi_precision, batch {shape}: params={n_params} losses={losses} "
        f"step_ms={step_s * 1e3} (mean of {timed} after {warmup} warm-up; "
        f"each {[t * 1e3 for t in seconds]}) {unit}={rate} mfu={mfu} "
        f"peak_memory_bytes={peak} launches={counts} (per step {want}) "
        f"({card})")
    check(all(np.isfinite(losses)), f"{family}: non-finite training loss")
    check(losses[-1] < losses[0], f"{family}: training loss did not fall: "
          f"{losses}")
    device_ms, idle = profile_train_window(step, batch, step_s * 1e3,
                                           label=f"{family}-train")
    log(f"[family-train] {family} seconds={time.perf_counter() - t0}")
    del model, step, batch
    release_device_memory()
    return dict(_totals(counts), forms=counts, layers=layers,
                batch=list(shape), step_ms=step_s * 1e3,
                rate=rate, unit=unit, mfu=mfu, peak=peak, losses=losses,
                device_ms=device_ms, idle_share=idle)


def phase_families(card):
    """Phase 13, the transformer families beside Llama: 13a K1-K4 at
    their attention shapes, 13b K5 and K10 at GPT-2 small's, 13c GPT-2
    small serving, 13d f32 training parity card vs CPU, 13e training at
    full width (GPT-2 small, BERT-base, DiT-XL/2). Returns every
    phase's numbers."""
    t0 = time.perf_counter()
    flash = phase_family_flash()
    k5, k10 = phase_gpt_kernels()
    runs = phase_gpt_serving(card)
    phase_family_train_parity()
    train = {f: train_family(f, card) for f in ("gpt", "bert", "dit")}
    log(f"[families] seconds={time.perf_counter() - t0}")
    return dict(flash=flash, k5=k5, k10=k10, runs=runs, train=train)


def families_only():
    """``--families``: K1-K5 and K10 built, then phase 13 alone."""
    from paddle_tpu_torch.ops.hopper import (flash_attention, int8_matmul,
                                             paged_attention)

    _, _, card = phase_device()
    with ThreadPoolExecutor(max_workers=3) as pool:
        list(pool.map(lambda build: build(), (
            flash_attention.build, paged_attention.build, int8_matmul.build)))
    phase_families(card)
    return 0


# -- phase 14: the Stable-Diffusion UNet (SD v1.5 training) -----------------

# SD v1.5's attention (UNetConfig(): heads of 8, 40/80/160 of them): self-
# attention at the four levels and cross-attention against the 77 text
# tokens, non-causal, batch 1 (the plain backward's f32 scores); f32 as
# the UNet trains, the 4096-query shapes in bf16 too; then d = 32 and
# d = 100 (zero-padded to 64 and 128). (name, dtype, b, sq, sk, h, kv, d,
# causal)
UNET_FLASH_CASES = [
    (f"{kind}_s{s}_sk{sk}_h{h}_d8_{str(dt).split('.')[-1]}", dt, 1, s, sk,
     h, h, 8, False)
    for s, h in ((4096, 40), (1024, 80), (256, 160), (64, 160))
    for kind, sk in (("self", s), ("cross", 77))
    for dt in ((torch.float32, torch.bfloat16) if s == 4096
               else (torch.float32,))
] + [
    ("self_s1024_sk1024_h20_d32_float32", torch.float32, 1, 1024, 1024, 20,
     20, 32, False),
    ("cross_s1024_sk77_h8_d100_bfloat16", torch.bfloat16, 1, 1024, 77, 8, 8,
     100, False),
]
# H100 SXM: MUFU.EX2 at 16 results a clock per SM (the CUDA C Programming
# Guide's throughput table, compute capability 9.0), 132 SMs at the 1.98
# GHz boost clock
EX2_PER_S = 132 * 16 * 1.98e9
# 14b: SD's channel widths cut to two levels and one layer a block, so
# that 40 and 80 heads of 8 run; 14c: SD v1.5, the first batch that fits
UNET_PARITY_CFG = dict(block_out_channels=(320, 640), layers_per_block=1,
                       attn_blocks=(True, True), sample_size=32)
UNET_BATCHES = (8, 4, 2)
UNET_CONTEXT = 77
UNET_TRANSFORMER_BLOCKS = 16
UNET_FAMILIES = (("flash_fwd", ("flash_fwd_kernel",)),
                 ("flash_dq", ("flash_dq_kernel",)),
                 ("flash_dkv", ("flash_dkv_kernel",)),
                 ("conv", ("fprop", "dgrad", "wgrad", "convolve", "conv2d",
                           "cudnn", "winograd", "nchwToNhwc", "nhwcToNchw")),
                 ("group_norm", ("RowwiseMoments", "ComputeFusedParams",
                                 "GroupNorm", "group_norm",
                                 "ComputeInternalGradients",
                                 "ComputeGradOutputCoeffs",
                                 "GammaBetaBackward")),
                 ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
                 ("elementwise", ("elementwise", "reduce_kernel")))


def unet_flash_bound(q, k, kernel):
    """Least time for one kernel's function at the true head_dim: the
    largest of the bytes (each input read once, each output written once)
    over the HBM rate, the products over the input type's peak
    (:func:`flash_bound`'s counts) and the ``b h sq sk`` exponentials
    each kernel takes (the forward's softmax; dq and dkv each rebuild P)
    over the SFU's ``ex2`` rate, EX2_PER_S. Returns (ms, "bytes" or
    "operations", the term: "bytes", "products" or "ex2")."""
    b, sq, h, _ = q.shape
    t_flash, by = flash_bound(dict(q=q, k=k, causal=False), kernel)
    t_exp = b * h * sq * k.shape[1] / EX2_PER_S * 1e3
    if t_exp > t_flash:
        return t_exp, "operations", "ex2"
    return t_flash, by, "bytes" if by == "bytes" else "products"


def phase_unet_flash():
    """Phase 14a: K1-K4 at SD v1.5's attention shapes, each through
    :func:`flash_check` (out, lse, dq, dk, dv against the plain versions;
    bf16 also row by row), two calls of the forward and of the backward
    giving equal bits, and timed (:func:`time_flash_case`, whose wrapper
    times include the zero padding to 64 or 128) against the three-term
    bound of :func:`unet_flash_bound`. Returns {case: errors and
    times}."""
    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2014)
    results = {}
    for name, dt, b, sq, sk, h, kv, d, causal in UNET_FLASH_CASES:
        def rnd(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(dt)

        q, k, v = rnd(b, sq, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d)
        do = rnd(b, sq, h, d)
        scale = 1.0 / d ** 0.5
        errs, out, lse = flash_check(name, q, k, v, do, causal, scale)
        fwd = [fa.flash_attention_fwd_cuda(q, k, v, causal, scale)
               for _ in range(2)]
        bwd = [fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal,
                                           scale) for _ in range(2)]
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(*fwd))
              and all(torch.equal(x, y) for x, y in zip(*bwd)),
              f"flash {name}: two calls differ")
        del fwd, bwd
        r = dict(errs, **time_flash_case(q, k, v, do, out, lse, causal,
                                         scale))
        for kernel in ("fwd", "dq", "dkv"):
            (r[f"{kernel}_bound_ms"], r[f"{kernel}_bound_by"],
             r[f"{kernel}_bound_term"]) = unet_flash_bound(q, k, kernel)
        r["padding_fwd_ms"] = r["fwd_ms"] - r["fwd_kernel_ms"]
        log(f"[unet-flash] {name} padded_to={fa.padded_head_dim(d)} "
            + " ".join(f"{key}={val}" for key, val in r.items()))
        results[name] = r
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return results


def _unet_batch(batch, size, device, seed=0):
    """Latents ``[B, 4, size, size]``, timesteps in [0, 1000), a
    ``[B, 77, 768]`` text context and the noise target, from a seeded
    ``torch.Generator``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(batch, 4, size, size, device=device, generator=gen)
    t = torch.randint(0, 1000, (batch,), device=device, generator=gen)
    ctx = torch.randn(batch, UNET_CONTEXT, 768, device=device, generator=gen)
    noise = torch.randn(batch, 4, size, size, device=device, generator=gen)
    return x, t, ctx, noise


def phase_unet_train_parity():
    """Phase 14b: a UNet of SD v1.5's widths cut to two levels
    (UNET_PARITY_CFG: 40 and 80 heads of 8, cross-attention against 77
    tokens), f32, TF32 off: its weights built on the CPU and copied to
    the card; one forward/backward of ``sd_loss_fn`` on the card (flash
    kernels at d=8 padded to 64) against the CPU (plain versions), the
    loss to TRAIN_LOSS_RTOL and every gradient to TRAIN_GRAD_REL of its
    largest element; then 2 AdamW TrainSteps on each device, the losses
    to TRAIN_TRAJ_RTOL."""
    from paddle_tpu_torch import (TrainStep, UNet2DConditionModel,
                                  UNetConfig, load_reference_state,
                                  sd_loss_fn)
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = UNetConfig(**UNET_PARITY_CFG)
    host = UNet2DConditionModel(cfg, device="cpu", seed=5)
    card = UNet2DConditionModel(cfg, seed=6)
    load_reference_state(card, {n: p.detach().numpy()
                                for n, p in host.named_parameters()})
    batch = _unet_batch(1, cfg.sample_size, "cpu", seed=21)
    losses = {}
    for dev, model in (("cuda", card), ("cpu", host)):
        loss = sd_loss_fn(model, *(t.to(dev) for t in batch))
        loss.backward()
        losses[dev] = float(loss.detach())
    err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    check(err <= TRAIN_LOSS_RTOL, f"unet: f32 loss differs card vs CPU "
          f"({losses})")
    host_params = dict(host.named_parameters())
    worst = ("", 0.0)
    for n, p in card.named_parameters():
        e = _max_rel_err(p.grad, host_params[n].grad)
        worst = max(worst, (n, e), key=lambda x: x[1])
        check(e <= TRAIN_GRAD_REL, f"unet: gradient of {n} differs card vs "
              f"CPU: {e} of its largest element")
    for model in (card, host):
        for p in model.parameters():
            p.grad = None
    traj = {}
    for dev, model in (("cuda", card), ("cpu", host)):
        step = TrainStep(model, AdamW(learning_rate=1e-5), sd_loss_fn)
        traj[dev] = [float(step(*(t.to(dev) for t in batch)))
                     for _ in range(2)]
    rel = [abs(a - b) / abs(b) for a, b in zip(traj["cuda"], traj["cpu"])]
    log(f"[unet-parity] SD widths (320, 640), 1 layer a block, 32^2, "
        f"batch 1, f32: "
        f"loss card={losses['cuda']} cpu={losses['cpu']} rel_err={err}; all "
        f"{len(host_params)} gradients within {TRAIN_GRAD_REL}, worst "
        f"{worst[0]} {worst[1]}; 2 AdamW steps card={traj['cuda']} cpu="
        f"{traj['cpu']} rel_err={rel}; seconds={time.perf_counter() - t0}")
    check(max(rel) <= TRAIN_TRAJ_RTOL, "unet: f32 TrainStep losses differ "
          "card vs CPU")
    del card, host, step
    torch.cuda.empty_cache()


def unet_forward_flops(model, batch):
    """Forward FLOPs of one ``model(*batch[:3])`` at the true widths,
    counted by hooks: 2 x MACs of every conv (``out.numel()`` times the
    weight's ``in/groups x kh x kw``) and every linear (``out.numel()``
    times ``in``), and 4 b h n m d of every attention (QK^T and PV)."""
    from paddle_tpu_torch.models.unet import CrossAttention
    from paddle_tpu_torch.nn.layer import Conv2D, Linear

    total = [0]

    def hook(module, args, out):
        if isinstance(module, Conv2D):
            total[0] += 2 * out.numel() * module.weight[0].numel()
        elif isinstance(module, Linear):
            total[0] += 2 * out.numel() * module.weight.shape[0]
        else:
            x = args[0]
            m = (args[1] if len(args) > 1 and args[1] is not None
                 else x).shape[1]
            total[0] += (4 * x.shape[0] * module.heads * x.shape[1] * m
                         * module.head_dim)

    handles = [mod.register_forward_hook(hook) for mod in model.modules()
               if isinstance(mod, (Conv2D, Linear, CrossAttention))]
    try:
        with torch.no_grad():
            model(*batch[:3])
    finally:
        for h in handles:
            h.remove()
    return total[0]


def phase_unet_training(card, warmup=2, timed=3):
    """Phase 14c: SD v1.5 (``UNetConfig()``: 64^2 latents, 77-token
    context, 16 TransformerBlocks of 40/80/160 heads of 8) trained in f32
    (TF32 off) with AdamW at learning rate 1e-4, at the first of batch
    8/4/2 that fits: ``warmup`` + ``timed`` steps, each launching exactly
    32 flash forwards, 32 dq and 32 dkv kernels (self- and
    cross-attention of every TransformerBlock); the loss finite and
    falling; step ms, samples/s, MFU (3 x the forward's FLOPs over the
    f32 peak), parameters, peak memory, then a torch.profiler window by
    family (flash, conv, GroupNorm, matmul, elementwise) and the idle
    share. Returns the numbers."""
    from paddle_tpu_torch import (TrainStep, UNet2DConditionModel,
                                  UNetConfig, sd_loss_fn)
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    per = 2 * UNET_TRANSFORMER_BLOCKS
    want = dict(fwd=per, dq=per, dkv=per, k6=0)
    for b in UNET_BATCHES:
        torch.cuda.synchronize()
        release_device_memory()
        torch.cuda.reset_peak_memory_stats()
        model = UNet2DConditionModel(UNetConfig(), seed=0)
        cfg = model.config
        n_params = sum(p.numel() for p in model.parameters())
        step = TrainStep(model, AdamW(learning_rate=1e-4), sd_loss_fn)
        batch = _unet_batch(b, cfg.sample_size, "cuda")
        losses, seconds = [], []
        _reset_train_counts()
        try:
            for i in range(warmup + timed):
                before = _train_counts()
                torch.cuda.synchronize()
                ts = time.perf_counter()
                losses.append(float(step(*batch)))
                seconds.append(time.perf_counter() - ts)
                got = _totals(_step_counts(before, _train_counts()))
                check(got == want, f"unet training step {i}: launches {got} "
                      f"!= {want}")
        except torch.cuda.OutOfMemoryError:
            log(f"[unet-train] batch {b}: out of memory, trying the next")
            del model, step, batch
            continue
        break
    else:
        raise SmokeFailure(f"unet: no batch of {UNET_BATCHES} fits")
    counts = _train_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(seconds[warmup:]) / timed
    rate = b / step_s
    flops = unet_forward_flops(model, batch)
    mfu = 3 * flops * rate / b / PEAK_OPS_S[torch.float32]
    log(f"[unet-train] SD v1.5 (UNetConfig()), f32 (TF32 off), AdamW lr "
        f"1e-4, batch {b} x 64^2, context 77 x 768: params={n_params} "
        f"losses={losses} step_ms={step_s * 1e3} (mean of {timed} after "
        f"{warmup} warm-up; each {[t * 1e3 for t in seconds]}) "
        f"samples_per_s={rate} forward_flops_per_step={flops} mfu={mfu} "
        f"(3 x forward FLOPs x samples/s / batch over "
        f"{PEAK_OPS_S[torch.float32]}) peak_memory_bytes={peak} "
        f"launches={counts} (per step {want}) ({card})")
    check(all(np.isfinite(losses)), "unet: non-finite training loss")
    check(losses[-1] < losses[0], f"unet: training loss did not fall: "
          f"{losses}")
    device_ms, idle = profile_train_window(step, batch, step_s * 1e3,
                                           label="unet-train",
                                           families=UNET_FAMILIES)
    log(f"[unet-train] seconds={time.perf_counter() - t0}")
    del model, step, batch
    release_device_memory()
    return dict(_totals(counts), forms=counts, batch=b, params=n_params,
                step_ms=step_s * 1e3,
                rate=rate, unit="samples_per_s", mfu=mfu, peak=peak,
                losses=losses, forward_flops=flops, device_ms=device_ms,
                idle_share=idle)


def phase_unet(card):
    """Phase 14, the Stable-Diffusion UNet: 14a K1-K4 at SD v1.5's
    attention shapes, 14b f32 training parity card vs CPU at SD's widths
    cut to two levels, 14c SD v1.5 training at full width in f32.
    Returns every phase's numbers."""
    t0 = time.perf_counter()
    flash = phase_unet_flash()
    phase_unet_train_parity()
    train = phase_unet_training(card)
    log(f"[unet] seconds={time.perf_counter() - t0}")
    return dict(flash=flash, train=train)


def unet_only():
    """``--unet``: the flash library built, then phase 14 alone."""
    from paddle_tpu_torch.ops.hopper import flash_attention

    _, _, card = phase_device()
    flash_attention.build()
    phase_unet(card)
    return 0


# -- phase 15: amp ------------------------------------------------------------

# 15a: K1-K4 in fp16 at Llama-2-7B's training shape and SD v1.5's
# 4096-token self-attention (d=8, padded to 64); then head_dim 256 in f32,
# bf16 and fp16: b=1 s=2048 h=8 causal and non-causal, a ragged 2048 x 77
# non-causal (cross-attention's key count), and d=160 (padded to 256)
# (name, dtype, b, sq, sk, h, kv, d, causal)
AMP_FLASH_CASES = [
    ("llama_causal_b2_s4096_h32_d128_fp16", torch.float16, 2, 4096, 4096,
     32, 32, 128, True),
    ("sd_self_b1_s4096_h40_d8_fp16", torch.float16, 1, 4096, 4096, 40, 40,
     8, False),
] + [
    (f"{kind}_{str(dt).split('.')[-1]}", dt, 1, 2048, sk, 8, 8, d, causal)
    for dt in (torch.float32, torch.bfloat16, torch.float16)
    for kind, sk, d, causal in (("d256_causal_s2048_h8", 2048, 256, True),
                                ("d256_noncausal_s2048_h8", 2048, 256, False),
                                ("d256_ragged_sq2048_sk77_h8", 77, 256, False),
                                ("d160_padded_s2048_h8", 2048, 160, False))]
# 15b: card against CPU in bf16 and fp16. Each side rounds at its own
# points (cuDNN's and MKL-DNN's convolutions, the flash kernels' P and dS
# against the plain versions' f32 P, other orders of the sums), so a
# 16-bit loss agrees to about 2^-8 of itself and a gradient, over a few
# dozen ops each rounding to 2^-9, to a few percent of its L2 norm: the
# loss to AMP_LOSS_RTOL, each gradient to AMP_GRAD_L2 (relative L2)
AMP_LOSS_RTOL = 2.0 ** -6
AMP_GRAD_L2 = 2.0 ** -4
AMP_TINY_UNET = dict(block_out_channels=(32, 64), layers_per_block=1,
                     cross_attention_dim=32, attention_head_dim=8,
                     norm_num_groups=8, sample_size=16,
                     attn_blocks=(True, False))
# 15d: the first of these batches of 4096 tokens that fits
AMP_LLAMA_BATCHES = (2, 1)
AMP_INIT_SCALE = 65536.0


def amp_flash_bound(q, k, causal, kernel):
    """Least time for one kernel's function at the true head_dim: the
    larger of :func:`flash_bound` (bytes; products over the input type's
    peak) and the ``b h sq sk`` exponentials (halved when causal) over
    the SFU's ex2 rate. Returns (ms, "bytes" or "operations")."""
    b, sq, h, _ = q.shape
    t, by = flash_bound(dict(q=q, k=k, causal=causal), kernel)
    t_exp = (b * h * sq * k.shape[1] / (2 if causal else 1) / EX2_PER_S
             * 1e3)
    return (t_exp, "operations") if t_exp > t else (t, by)


def phase_amp_flash():
    """Phase 15a: each case of AMP_FLASH_CASES through
    :func:`flash_check` (out, lse, dq, dk, dv against the plain versions,
    16-bit outputs also row by row, fp16 to its own limits), two calls of
    the forward and of the backward giving equal bits, then timed by CUDA
    events (:func:`time_flash_case`: wrappers with their padding, kernels
    alone, plain versions, SDPA) against :func:`amp_flash_bound`, for the
    table. Returns {case: errors and times}."""
    from paddle_tpu_torch.ops.hopper import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(2115)
    results = {}
    for name, dt, b, sq, sk, h, kv, d, causal in AMP_FLASH_CASES:
        def rnd(*shape):
            return torch.randn(*shape, device="cuda", generator=gen).to(dt)

        q, k, v = rnd(b, sq, h, d), rnd(b, sk, kv, d), rnd(b, sk, kv, d)
        do = rnd(b, sq, h, d)
        scale = 1.0 / d ** 0.5
        errs, out, lse = flash_check(name, q, k, v, do, causal, scale)
        fwd = [fa.flash_attention_fwd_cuda(q, k, v, causal, scale)
               for _ in range(2)]
        bwd = [fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal,
                                           scale) for _ in range(2)]
        torch.cuda.synchronize()
        same = (all(torch.equal(x, y) for x, y in zip(*fwd))
                and all(torch.equal(x, y) for x, y in zip(*bwd)))
        check(same, f"flash {name}: two calls differ")
        del fwd, bwd
        r = dict(errs, bitwise_equal=same, **time_flash_case(
            q, k, v, do, out, lse, causal, scale))
        for kernel in ("fwd", "dq", "dkv"):
            r[f"{kernel}_bound_ms"], r[f"{kernel}_bound_by"] = \
                amp_flash_bound(q, k, causal, kernel)
        log(f"[amp-flash] {name} padded_to={fa.padded_head_dim(d)} "
            + " ".join(f"{key}={val}" for key, val in r.items()))
        results[name] = r
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    return results


def _l2_rel_err(got, want):
    g, w = got.detach().cpu().float(), want.detach().float()
    return float((g - w).norm() / w.norm().clamp(min=1e-30))


def _amp_compare(label, losses, grads):
    """The card's loss and gradients against the CPU's (AMP_LOSS_RTOL,
    AMP_GRAD_L2); logs the worst gradient."""
    err = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    worst = max(((n, _l2_rel_err(g, grads["cpu"][n]))
                 for n, g in grads["cuda"].items()), key=lambda x: x[1])
    log(f"[amp-parity] {label}: loss card={losses['cuda']} cpu="
        f"{losses['cpu']} rel_err={err} (tol {AMP_LOSS_RTOL}); "
        f"{len(grads['cpu'])} gradients, worst relative L2 {worst[0]} "
        f"{worst[1]} (tol {AMP_GRAD_L2})")
    check(err <= AMP_LOSS_RTOL, f"amp {label}: loss differs card vs CPU")
    check(worst[1] <= AMP_GRAD_L2, f"amp {label}: gradient of {worst[0]} "
          f"differs card vs CPU")


def phase_amp_parity():
    """Phase 15b: the tiny UNet (heads of 8: the bf16 kernels at d=8
    padded to 64) through ``TrainStep`` under ``auto_cast`` O1 bf16 and
    O2 bf16 (``decorate``; f32 AdamW masters), and the tiny Llama eager
    under O1 fp16 with a ``GradScaler``: the loss and every gradient on
    the card (kernels) against the port on the CPU (plain versions),
    from the same weights and inputs."""
    from paddle_tpu_torch import (LlamaConfig, LlamaForCausalLM, TrainStep,
                                  UNet2DConditionModel, UNetConfig, amp,
                                  load_reference_state, sd_loss_fn)
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = UNetConfig(**AMP_TINY_UNET)
    base = UNet2DConditionModel(cfg, device="cpu", seed=15)
    state = {n: p.detach().numpy() for n, p in base.named_parameters()}
    gen = torch.Generator().manual_seed(152)
    batch = (torch.randn(2, 4, 16, 16, generator=gen),
             torch.tensor([17, 901]), torch.randn(2, 77, 32, generator=gen),
             torch.randn(2, 4, 16, 16, generator=gen))
    for level in ("O1", "O2"):
        losses, grads = {}, {}
        for dev in ("cuda", "cpu"):
            model = UNet2DConditionModel(cfg, device=dev, seed=0)
            load_reference_state(model, state)
            if level == "O2":
                amp.decorate(model, level="O2", dtype="bfloat16")
            kept = {}

            def keep(g, kept=kept):
                kept.update({n: t.clone() for n, t in g.items()})
                return g

            step = TrainStep(model, AdamW(learning_rate=1e-4,
                                          multi_precision=True),
                             sd_loss_fn, grad_postprocess=keep)
            with amp.auto_cast(level=level, dtype="bfloat16"):
                losses[dev] = float(step(*(t.to(dev) for t in batch)))
            grads[dev] = kept
        _amp_compare(f"tiny UNet TrainStep {level} bf16", losses, grads)
    lcfg = LlamaConfig.tiny(max_position_embeddings=256)
    host = LlamaForCausalLM(lcfg, device="cpu", seed=15)
    ids = torch.randint(0, lcfg.vocab_size, (2, 257), generator=gen)
    ids, labels = ids[:, :-1], ids[:, 1:]
    losses, grads = {}, {}
    for dev in ("cuda", "cpu"):
        model = LlamaForCausalLM(lcfg, device=dev, seed=0)
        load_reference_state(model, {n: p.detach().numpy()
                                     for n, p in host.named_parameters()})
        opt = AdamW(learning_rate=1e-3, parameters=model.parameters())
        scaler = amp.GradScaler(init_loss_scaling=1024.0)
        with amp.auto_cast(level="O1", dtype="float16"):
            _, loss = model(ids.to(dev), labels=labels.to(dev))
        scaler.scale(loss).backward()
        scaler.unscale_(opt)
        check(not scaler._found_inf, f"amp tiny Llama on {dev}: the "
              f"scaler found inf/nan in finite gradients")
        losses[dev] = float(loss.detach())
        grads[dev] = {n: p.grad.clone() for n, p in model.named_parameters()}
        scaler.step(opt)
        scaler.update()
    _amp_compare("tiny Llama eager O1 fp16 GradScaler", losses, grads)
    log(f"[amp-parity] seconds={time.perf_counter() - t0}")
    torch.cuda.empty_cache()


def phase_amp_unet(card, warmup=2, timed=3):
    """Phase 15c: SD v1.5 (``UNetConfig()``) with f32 parameters trained
    under ``auto_cast(level="O1")`` (bf16), AdamW at lr 1e-4 through
    ``TrainStep``, at the first of UNET_BATCHES that fits: ``warmup`` +
    ``timed`` steps, each launching exactly 32 bf16 flash forwards, 32
    bf16 dq and 32 bf16 dkv (by the wrappers' counts by form, 64 wide); the
    loss finite and falling; step ms, samples/s, MFU (3 x the forward's
    FLOPs over the bf16 peak), peak memory, then a torch.profiler window
    by family with the idle share. Returns the numbers."""
    from paddle_tpu_torch import (TrainStep, UNet2DConditionModel,
                                  UNetConfig, amp, sd_loss_fn)
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    per = 2 * UNET_TRANSFORMER_BLOCKS
    # SD v1.5's heads are 8 wide (F6): the bf16 kernels at 64, padded
    bf16 = f"{torch.bfloat16}/d64"
    want = dict(fwd={bf16: per}, dq={bf16: per}, dkv={bf16: per}, k6={})
    for b in UNET_BATCHES:
        torch.cuda.synchronize()
        release_device_memory()
        torch.cuda.reset_peak_memory_stats()
        model = UNet2DConditionModel(UNetConfig(), seed=0)
        cfg = model.config
        step = TrainStep(model, AdamW(learning_rate=1e-4), sd_loss_fn)
        batch = _unet_batch(b, cfg.sample_size, "cuda")
        losses, seconds = [], []
        _reset_train_counts()
        try:
            for i in range(warmup + timed):
                before = _train_counts()
                torch.cuda.synchronize()
                ts = time.perf_counter()
                with amp.auto_cast(level="O1"):
                    losses.append(float(step(*batch)))
                seconds.append(time.perf_counter() - ts)
                got = _step_counts(before, _train_counts())
                check(got == want, f"amp unet step {i}: launches {got} != "
                      f"{want}")
        except torch.cuda.OutOfMemoryError:
            log(f"[amp-unet] batch {b}: out of memory, trying the next")
            del model, step, batch
            continue
        break
    else:
        raise SmokeFailure(f"amp unet: no batch of {UNET_BATCHES} fits")
    counts = _train_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(seconds[warmup:]) / timed
    rate = b / step_s
    flops = unet_forward_flops(model, batch)
    mfu = 3 * flops * rate / b / PEAK_OPS_S[torch.bfloat16]
    log(f"[amp-unet] SD v1.5 (UNetConfig()), f32 parameters, "
        f"auto_cast O1 bf16, AdamW lr 1e-4, batch {b} x 64^2, context 77 x "
        f"768: losses={losses} step_ms={step_s * 1e3} (mean of {timed} "
        f"after {warmup} warm-up; each {[t * 1e3 for t in seconds]}) "
        f"samples_per_s={rate} mfu={mfu} (3 x forward FLOPs "
        f"{flops} x samples/s / batch over {PEAK_OPS_S[torch.bfloat16]}) "
        f"peak_memory_bytes={peak} launches_by_form={counts} (per step "
        f"{want}) ({card})")
    check(all(np.isfinite(losses)), "amp unet: non-finite training loss")
    check(losses[-1] < losses[0], f"amp unet: training loss did not fall: "
          f"{losses}")

    def o1_step(*args):
        with amp.auto_cast(level="O1"):
            return step(*args)

    device_ms, idle = profile_train_window(o1_step, batch, step_s * 1e3,
                                           label="amp-unet",
                                           families=UNET_FAMILIES)
    log(f"[amp-unet] seconds={time.perf_counter() - t0}")
    del model, step, batch
    release_device_memory()
    return dict(_totals(counts), forms=counts, batch=b,
                step_ms=step_s * 1e3, rate=rate, unit="samples_per_s",
                mfu=mfu, peak=peak, losses=losses,
                device_ms=device_ms, idle_share=idle,
                per_step=dict(fwd=per, dq=per, dkv=per))


def phase_amp_llama(card, warmup=2, timed=3):
    """Phase 15d: Llama-2-7B's widths cut to TRAIN_LAYERS layers, as
    phase 9 runs them (fused head loss) but with f32 weights, eager under
    ``auto_cast(level="O1", dtype="float16")`` with
    ``GradScaler(init_loss_scaling=65536)`` and an eager AdamW (lr
    1e-4), at 4096 tokens a row and the first of AMP_LLAMA_BATCHES that
    fits: every step launches 8 fp16 flash forwards, 8 dq and 8 dkv and
    17 K6 forwards, all f32 (``rms_norm`` is black-listed); the scale
    and whether the step applied are logged after each step; at least
    one step applies and the loss stays finite. The projections stay f32
    (F8: amp does not reach the parallel linears, as in the JAX
    package). Returns the numbers."""
    from paddle_tpu_torch import LlamaConfig, LlamaForCausalLM, amp
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    f16, f32 = f"{torch.float16}/d128", str(torch.float32)
    n = TRAIN_LAYERS
    want = dict(fwd={f16: n}, dq={f16: n}, dkv={f16: n},
                k6={f32: 2 * n + 1})
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=n, fused_head_loss=True,
                                dtype="float32")
    for b in AMP_LLAMA_BATCHES:
        torch.cuda.synchronize()
        release_device_memory()
        torch.cuda.reset_peak_memory_stats()
        model = LlamaForCausalLM(cfg, seed=0)
        opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
        scaler = amp.GradScaler(init_loss_scaling=AMP_INIT_SCALE)
        gen = torch.Generator(device="cuda").manual_seed(0)
        ids = torch.randint(0, cfg.vocab_size, (b, TRAIN_SEQ + 1),
                            device="cuda", generator=gen)
        ids, labels = ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
        losses, seconds, scales, applied = [], [], [], []
        _reset_train_counts()
        try:
            for i in range(warmup + timed):
                before = _train_counts()
                torch.cuda.synchronize()
                ts = time.perf_counter()
                with amp.auto_cast(level="O1", dtype="float16"):
                    _, loss = model(ids, labels=labels)
                scaler.scale(loss).backward()
                scaler.unscale_(opt)
                applied.append(not scaler._found_inf)
                scaler.step(opt)
                scaler.update()
                opt.clear_grad()
                losses.append(float(loss.detach()))
                seconds.append(time.perf_counter() - ts)
                scales.append(float(scaler.get_loss_scaling()))
                got = _step_counts(before, _train_counts())
                log(f"[amp-llama] step {i}: loss={losses[-1]} applied="
                    f"{applied[-1]} scale_after={scales[-1]} ms="
                    f"{seconds[-1] * 1e3}")
                check(got == want, f"amp llama step {i}: launches {got} "
                      f"!= {want}")
        except torch.cuda.OutOfMemoryError:
            log(f"[amp-llama] batch {b}: out of memory, trying the next")
            del model, opt, scaler
            continue
        break
    else:
        raise SmokeFailure(f"amp llama: no batch of {AMP_LLAMA_BATCHES} "
                           f"fits")
    counts = _train_counts()
    n_params = sum(p.numel() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated()
    step_s = sum(seconds[warmup:]) / timed
    tok_s = b * TRAIN_SEQ / step_s
    log(f"[amp-llama] llama2_7b widths, {n} layers, f32 weights, auto_cast "
        f"O1 fp16, GradScaler({AMP_INIT_SCALE}), eager AdamW, batch {b} x "
        f"{TRAIN_SEQ}: params={n_params} losses={losses} applied={applied} "
        f"scales={scales} step_ms={step_s * 1e3} (mean of {timed} after "
        f"{warmup} warm-up) tokens_per_s={tok_s} mfu="
        f"{6 * n_params * tok_s / PEAK_OPS_S[torch.bfloat16]} (6*N*tokens/s "
        f"over the 16-bit peak; the projections run in f32, F8) "
        f"peak_memory_bytes={peak} launches_by_form={counts} (per "
        f"step {want}) ({card})")
    check(all(np.isfinite(losses)), "amp llama: non-finite loss")
    check(any(applied), "amp llama: the scaler skipped every step")
    log(f"[amp-llama] seconds={time.perf_counter() - t0}")
    del model, opt, scaler
    release_device_memory()
    return dict(_totals(counts), forms=counts, batch=b, step_ms=step_s * 1e3,
                rate=tok_s,
                peak=peak, losses=losses, scales=scales, applied=applied,
                per_step=dict(fwd=n, dq=n, dkv=n, k6=2 * n + 1))


def phase_amp(card):
    """Phase 15, amp: 15a K1-K4 in fp16 and at head_dim 256, 15b card
    against CPU under auto_cast, 15c SD v1.5 under O1 (bf16), 15d
    Llama-2-7B's widths at 8 layers under O1 fp16 with a GradScaler.
    Returns every phase's numbers."""
    t0 = time.perf_counter()
    flash = phase_amp_flash()
    phase_amp_parity()
    unet = phase_amp_unet(card)
    llama = phase_amp_llama(card)
    log(f"[amp] seconds={time.perf_counter() - t0}")
    return dict(flash=flash, unet=unet, llama=llama)


def flash_part(form):
    """The kernels line's entry a flash launch of ``form`` (a wrapper's
    ``launches_by_form`` key, ``torch.float16/d128``) counts under:
    ``"d256"`` at head_dim 256, else ``"fp16"`` for fp16, else ``""``."""
    dtype, width = form.rsplit("/d", 1)
    if width == "256":
        return "d256"
    return "fp16" if dtype == str(torch.float16) else ""


def amp_kernel_entries(amp, src, pallas, launches_by_run):
    """The ``kernels`` line's entries for K1-K4's fp16 and 256-wide forms:
    fp16 at Llama's causal shape, then the 256-wide forms (every type) at
    15a's bf16 causal case, each with 15a's other cases beside it. Their
    launches are those of their forms in every main path's run
    (``launches_by_run(kernel, form)``): 15d is the fp16 kernels' path; no
    model of the repository has heads wider than 128, so the 256-wide
    forms count what the runs show, 0 unless that changes. At head_dim
    256 one dkv call launches a dK and a dV kernel, counted as two."""
    flash = amp["flash"]
    entries = []
    for form, main in (("fp16", "llama_causal_b2_s4096_h32_d128_fp16"),
                       ("d256", "d256_causal_s2048_h8_bfloat16")):
        cases = {n: r for n, r in flash.items()
                 if ("fp16" in n and "d256" not in n and "d160" not in n)
                 == (form == "fp16")}
        for kernel, line, tri, errs, keys in (
                ("fwd", 298, 172, ("out", "lse"),
                 ("fwd_ms", "plain_fwd_ms", "library_fwd_ms")),
                ("dq", 673, 567, ("dq",),
                 ("dq_kernel_ms", "plain_bwd_ms", "library_bwd_ms")),
                ("dkv", 703, 610, ("dk", "dv"),
                 ("dkv_kernel_ms", "plain_bwd_ms", "library_bwd_ms"))):
            r = cases[main]
            by_run = launches_by_run(kernel, form)
            entries.append(dict(
                name=f"flash_attention_{kernel}_{form}", route="cuda",
                source=src, replaces=f"{pallas}:{line}",
                also_replaces=[f"{pallas}:{tri}"],
                launches=sum(by_run.values()),
                launches_by_run={k: n for k, n in by_run.items() if n},
                **({"note": "one dkv call at head_dim 256 launches a dK "
                            "and a dV kernel, counted as two launches"}
                   if (kernel, form) == ("dkv", "d256") else {}),
                max_abs_err=max(c[e] for c in cases.values() for e in errs),
                ms=r[keys[0]], plain_ms=r[keys[1]], library_ms=r[keys[2]],
                bound_ms=r[f"{kernel}_bound_ms"],
                bound_by=r[f"{kernel}_bound_by"], shape=main,
                other_shapes={n: {k: c[k] for k in (
                    *keys, f"{kernel}_bound_ms", f"{kernel}_bound_by")}
                    for n, c in cases.items() if n != main}))
    return entries


def amp_only():
    """``--amp``: the flash and K6 libraries built, then phase 15 alone."""
    from paddle_tpu_torch.ops.hopper import flash_attention, rms_norm

    _, _, card = phase_device()
    with ThreadPoolExecutor(2) as pool:
        for nvcc_log in pool.map(lambda m: m.build(),
                                 (flash_attention, rms_norm)):
            log_ptxas(nvcc_log)
    phase_amp(card)
    return 0


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
        if any(w in line for w in ("registers", "spill", "smem", "arning",
                                   "C75")):
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
                    ["--norms"], ["--int8"], ["--int8-kernel"]) \
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
    if argv == ["--tier"]:
        return tier_only()
    if argv == ["--fleet"]:
        return fleet_only()
    if argv == ["--int8"]:
        return k10_only()
    if argv == ["--int8-kernel"]:
        k10_kernel_loop()
        return 0
    if argv == ["--families"]:
        return families_only()
    if argv == ["--unet"]:
        return unet_only()
    if argv == ["--amp"]:
        return amp_only()
    t_start = time.perf_counter()
    name, count, card = phase_device()
    phase_build()
    k5 = phase_k5()
    k6 = phase_k6()
    phase_k6_grad()
    flash = phase_flash()
    time_k5(k5)
    time_k6(k6)
    flash_times = time_flash(flash)
    k10 = phase_k10()
    k10_times = time_k10(k10)
    k10_host_parts(k10)
    phase_parity()
    runs = phase_serving(card)
    k5_launches = sum(r["k5"] for r in runs.values())
    k6_launches = sum(r["k6"] for r in runs.values())
    phase_train_parity()
    train = phase_training()
    phase_training(recompute=True, plain=train)
    t_resnet = time.perf_counter()
    ru_results = phase_resnet_kernels()
    ru_errs = {k: v["errs"] for k, v in ru_results.items()}
    ru_times = time_resnet_kernels(ru_results)
    phase_block_parity()
    resnet = phase_resnet_training()
    t_resnet = time.perf_counter() - t_resnet
    t_families = time.perf_counter()
    families = phase_families(card)
    t_families = time.perf_counter() - t_families
    t_unet = time.perf_counter()
    unet = phase_unet(card)
    t_unet = time.perf_counter() - t_unet
    t_amp = time.perf_counter()
    amp = phase_amp(card)
    t_amp = time.perf_counter() - t_amp
    runs.update(families["runs"])
    k5["gpt_decode_b8_h12_d64"] = families["k5"]
    k5_launches = sum(r["k5"] for r in runs.values())
    # every main path that runs K1-K4, each counted from 0 just before it
    trains = dict(llama=train, **families["train"], unet=unet["train"],
                  amp_unet=amp["unet"], amp_llama=amp["llama"])

    def launches_by_run(kernel, part):
        """``kernel``'s launches in each run, of the forms of one entry
        of the kernels line: ``""`` f32 and bf16 up to 128 wide,
        ``"fp16"`` fp16 up to 128 wide, ``"d256"`` 256 wide."""
        return {k: sum(n for f, n in t["forms"][kernel].items()
                       if flash_part(f) == part) for k, t in trains.items()}
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    pallas = "paddle_tpu/ops/pallas/flash_attention.py"
    shape = FLASH_CASES[0][0]
    family_flash = families["flash"]
    unet_flash = unet["flash"]

    def flash_extra(kernel, errs):
        """The flash entry's launches by training run and the families'
        and the UNet's shapes, each with its times beside its bound."""
        keys = dict(fwd=("fwd_ms", "fwd_kernel_ms", "plain_fwd_ms",
                         "library_fwd_ms"),
                    dq=("bwd_ms", "dq_kernel_ms", "plain_bwd_ms",
                        "library_bwd_ms"),
                    dkv=("bwd_ms", "dkv_kernel_ms", "plain_bwd_ms",
                         "library_bwd_ms"))[kernel]
        def shapes(cases, extra):
            return {n: dict({k: r[k] for k in keys if k in r},
                            bound_ms=r[f"{kernel}_bound_ms"],
                            bound_by=r[f"{kernel}_bound_by"],
                            max_abs_err=max(r[e] for e in errs),
                            **{k: r[k] for k in extra if k in r})
                    for n, r in cases.items()}

        return dict(
            launches_by_run=launches_by_run(kernel, ""),
            family_shapes=shapes(family_flash, ("d64_fwd_ms", "d64_bwd_ms")),
            unet_shapes=shapes(unet_flash, (f"{kernel}_bound_term",
                                            "padding_fwd_ms")))

    def flash_launches(kernel):
        return sum(launches_by_run(kernel, "").values())

    def flash_err(*keys):
        """The largest error of ``keys`` over every flash case checked,
        the families' and the UNet's among them."""
        return max(e[k] for e in (*flash.values(), *family_flash.values(),
                                   *unet_flash.values())
                   for k in keys)

    kernels = [
        dict(k5_entry(k5_launches, k5),
             launches_by_run={k: r["k5"] for k, r in runs.items()}),
        dict(kernel_entry("rms_norm", "cuda",
                          "paddle_tpu_torch/csrc/rms_norm.cu",
                          "paddle_tpu/ops/pallas/rms_norm.py:55",
                          k6_launches, k6, "rows8_h4096"),
             launches_by_run={k: r["k6"] for k, r in runs.items()},
             graph_ms=k6["rows8_h4096"]["graph_ms"],
             host_us=k6["rows8_h4096"]["host_us"],
             other_shapes={k: {f: r[f] for f in (
                 "ms", "graph_ms", "library_ms", "library_graph_ms",
                 "bound_ms", "host_us")} for k, r in k6.items()
                 if r["main"] and k != "rows8_h4096"}),
        dict(timed_entry("flash_attention_fwd", "cuda", src, f"{pallas}:298",
                         flash_launches("fwd"), flash_err("out", "lse"),
                         flash_times["fwd"], shape),
             also_replaces=[f"{pallas}:172"],
             **flash_extra("fwd", ("out", "lse"))),
        dict(timed_entry("flash_attention_dq", "cuda", src, f"{pallas}:673",
                         flash_launches("dq"), flash_err("dq"),
                         flash_times["dq"], shape),
             also_replaces=[f"{pallas}:567"], **flash_extra("dq", ("dq",))),
        dict(timed_entry("flash_attention_dkv", "cuda", src, f"{pallas}:703",
                         flash_launches("dkv"), flash_err("dk", "dv"),
                         flash_times["dkv"], shape),
             also_replaces=[f"{pallas}:610"],
             **flash_extra("dkv", ("dk", "dv"))),
    ]
    main_k10 = k10_times[INT8_MAIN]
    kernels.append(dict(
        timed_entry("int8_matmul", "cuda",
                    "paddle_tpu_torch/csrc/int8_matmul.cu",
                    "paddle_tpu/distributed/fleet/mpu.py:132",
                    sum(r.get("k10", 0) for r in runs.values()),
                    max(r["max_err"] for r in k10.values()), main_k10,
                    INT8_MAIN),
        also_replaces=["paddle_tpu/models/llama.py:328"],
        note="no pl.pallas_call: XLA's fused convert+dot of _int8_matmul",
        graph_ms=main_k10["graph_ms"],
        library_graph_ms=main_k10["library_graph_ms"],
        launches_by_run={k: r["k10"] for k, r in runs.items()
                         if r.get("k10")},
        other_shapes=dict({c: t for c, t in k10_times.items()
                           if c != INT8_MAIN}, **families["k10"])))
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
    kernels += amp_kernel_entries(amp, src, pallas, launches_by_run)
    log(f"[done] seconds={time.perf_counter() - t_start} (of which the "
        f"ResNet phases 10-12: {t_resnet}, the families' phase 13: "
        f"{t_families}, the UNet's phase 14: {t_unet}, amp's phase 15: "
        f"{t_amp})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
