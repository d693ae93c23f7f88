#!/usr/bin/env python3
"""Time variants of K7's forward side by side on one card.

Each argument is a CUDA source with the same ``resnet_unit_fwd`` entry
point as ``paddle_tpu_torch/csrc/resnet_unit.cu`` (a copy of it as it
stood, or with a change under trial), optionally followed by
``:-DNAME[=VALUE],...`` compiler switches. With no argument it takes the
checkout's own source. All are built with nvcc in parallel
(``variant_harness.py``), then each is held against the port's plain
forward (y to 2 bf16 ulps of its largest element, s1 and s2 to 2e-5 of
theirs, two calls bitwise equal) and timed with CUDA events (mean of 20
calls after 3, the kernel and its reduction) at each of ResNet-50's
twelve K7 shapes at batch 256, the variants in turn at each shape; the
last line sums each variant's times over a training step's 32 launches.
The last variant's device ms by part (forward; reduction) follow each
shape, from a torch.profiler window (``chip_smoke.py``'s kernel names).
Run from the repository root on the card:

    python3 scripts/k7_fwd_variants.py [SOURCE.cu[:-DFLAG,...] ...]
"""

from __future__ import annotations

import ctypes
import sys
import tempfile

import torch

from variant_harness import (CSRC_DIR, ClockSampler, build_all, card,
                             spec_name, time_ms)

from k7_bwd_variants import SHAPES, parts_ms
from paddle_tpu_torch.ops.hopper import resnet_unit as ru

Y_REL, SUM_REL = 2.0 ** -7, 2e-5
# resnet_unit_fwd: x, w, a, b, y, part, stats, M, cin, cout, sms, stream
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def main() -> int:
    if not torch.cuda.is_available():
        print("k7_fwd_variants: needs a CUDA device", file=sys.stderr)
        return 2
    specs = sys.argv[1:] or [str(CSRC_DIR / "resnet_unit.cu")]
    with tempfile.TemporaryDirectory() as out_dir:
        fns = [fn for fn, _ in build_all(specs, out_dir, "resnet_unit_fwd",
                                         ARGTYPES)]
    print(card())
    gen = torch.Generator(device="cuda").manual_seed(2024)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clocks = ClockSampler()
    step_ms = {}
    for rows, cin, cout, pro, launches in SHAPES:
        x = torch.randn(rows, cin, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(cin, cout, device="cuda", generator=gen)
             * cin ** -0.5).bfloat16()
        a = (torch.rand(cin, device="cuda", generator=gen) + 0.5
             if pro else None)
        b = torch.randn(cin, device="cuda", generator=gen) * 0.5 if pro else None
        want = ru.conv1x1_bn_fwd_reference(x, w, a, b)
        stream = torch.cuda.current_stream().cuda_stream
        y = torch.empty(rows, cout, device="cuda", dtype=torch.bfloat16)
        # the partials: at most one per SM or per 128-row tile, whatever
        # kernel a variant picks
        part = torch.empty(max(sms, -(-rows // 128)), 2, cout, device="cuda")
        stats = torch.empty(2, cout, device="cuda")

        def ptr(t):
            return None if t is None else t.data_ptr()

        row = [f"{rows}x{cin}x{cout}{'+pro' if pro else ''} x{launches}:"]
        for spec, fn in zip(specs, fns):
            def call():
                return fn(x.data_ptr(), w.data_ptr(), ptr(a), ptr(b),
                          y.data_ptr(), part.data_ptr(), stats.data_ptr(),
                          rows, cin, cout, sms, stream)
            if call() != 0:
                raise SystemExit(f"{spec}: launch failed")
            torch.cuda.synchronize()
            first = (y.clone(), stats.clone())
            call()
            torch.cuda.synchronize()
            if not (torch.equal(first[0], y) and torch.equal(first[1], stats)):
                raise SystemExit(f"{spec}: two calls differ")
            for name, g, r in zip(("y", "s1", "s2"), (y, stats[0], stats[1]),
                                  want):
                rel = float((g.float() - r.float()).abs().max()
                            / r.float().abs().max())
                if rel > (Y_REL if name == "y" else SUM_REL):
                    raise SystemExit(f"{spec}: {name} disagrees ({rel})")
            ms = time_ms(call, 20, 3)
            step_ms[spec] = step_ms.get(spec, 0.0) + launches * ms
            if spec == specs[-1]:
                parts = parts_ms(call)
            row.append(f"{spec_name(spec)}={ms * 1e3:.1f}us")
        print(" ".join(row), flush=True)
        print(f"  {spec_name(specs[-1])} by part: {parts}", flush=True)
        del x, w, y, part, want
        torch.cuda.empty_cache()
    print("per training step (32 launches): " + " ".join(
        f"{spec_name(spec)}={ms:.3f}ms" for spec, ms in step_ms.items()))
    print(clocks.stop())
    return 0


if __name__ == "__main__":
    sys.exit(main())
