#!/usr/bin/env python3
"""Time source variants of K10 (``csrc/int8_matmul.cu``, the weight-only
int8 matmul) side by side on the card.

    python3 scripts/k10_variants.py A.cu B.cu:-DX ... [--sweep]

Each source is a copy of ``int8_matmul.cu`` (as it stands, or with a
change under trial; headers resolve from ``paddle_tpu_torch/csrc``) with
the same C entry point. At Llama-2-7B's four linear shapes with 1, 8,
64, 128 and 512 rows (bf16) every variant is checked against the plain
version (two bf16 ulps of the largest output, equal bits twice) and
timed by CUDA-graph replay with the launch of the checkout's
``int8_matmul_plan``; ``--sweep`` times every split of K the C call
takes (1, 2, 4 or 8 CTAs) as well. Prints the
card's name and power limit first, then one line a case and variant.
"""

from __future__ import annotations

import ctypes
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from variant_harness import (ROOT, build_all, card,  # noqa: E402
                             spec_name)

from paddle_tpu_torch.ops.hopper import int8_matmul as hop  # noqa: E402

SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
ROWS = (1, 8, 64, 128, 512)


def graph_ms(fn, iters=20, replays=5):
    """Mean ms a call: ``iters`` calls in one CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
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


def launches(plan, sweep):
    """(label, code) of the plan's launch and, with ``sweep``, of every
    other split of K the C call takes for the plan's row tile."""
    out = [("plan", plan["code"])]
    if not sweep:
        return out
    for splits in (1, 2, 4, 8):
        per = -(-plan["stages"] // splits)
        if -(-plan["stages"] // per) != splits:
            continue
        code = hop.plan_code(per, splits, plan["bm"], 1)
        if code != plan["code"]:
            out.append((f"splits={splits}", code))
    return out


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--sweep"]
    sweep = "--sweep" in sys.argv[1:]
    specs = args or [os.path.join(ROOT, "paddle_tpu_torch", "csrc",
                                  "int8_matmul.cu")]
    print(card(), flush=True)
    p, i = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        built = build_all(specs, tmp, "int8_matmul_launch",
                          [p] * 4 + [i] * 5 + [p])
        for spec, (_, log) in zip(specs, built):
            for line in log.splitlines():
                if any(w in line for w in ("registers", "spill", "arning",
                                           "C75")):
                    print(f"[build] {spec_name(spec)}: {line.strip()}")
        gen = torch.Generator(device="cuda").manual_seed(18)
        failures = 0
        for k, n in SHAPES:
            q = torch.randint(-127, 128, (k, n), device="cuda",
                              generator=gen, dtype=torch.int8)
            s = (0.02 + 0.01 * torch.rand(n, device="cuda",
                                          generator=gen)) / 127
            for m in ROWS:
                x = torch.randn(m, k, device="cuda",
                                generator=gen).bfloat16()
                want = hop.int8_matmul_plain(x, q, s).float()
                tol = 2.0 ** -6 * float(want.abs().max())
                plan = hop.int8_matmul_plan(m, n, k, torch.bfloat16)
                for spec, (fn, _) in zip(specs, built):
                    for label, code in launches(plan, sweep):
                        def call(out, _fn=fn, _code=code):
                            rc = _fn(x.data_ptr(), q.data_ptr(),
                                     s.data_ptr(), out.data_ptr(), m, n, k,
                                     _code, 0,
                                     torch.cuda.current_stream().cuda_stream)
                            assert rc == 0, f"CUDA error {rc}"
                            return out

                        got = call(torch.empty_like(want, dtype=x.dtype))
                        again = call(torch.empty_like(got))
                        torch.cuda.synchronize()
                        err = float((got.float() - want).abs().max())
                        ok = err <= tol and torch.equal(got, again)
                        failures += not ok
                        buf = torch.empty_like(got)
                        print(f"{k}x{n} m={m} {spec_name(spec)} {label} "
                              f"graph_ms={graph_ms(lambda: call(buf))} "
                              f"max_abs_err={err} ok={ok}", flush=True)
                del x
            del q
    print(f"failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
