#!/usr/bin/env python3
"""Time variants of K7's backward side by side on one card.

Each argument is a CUDA source with the same ``resnet_unit_bwd`` entry
point as ``paddle_tpu_torch/csrc/resnet_unit.cu`` (a copy of it as it
stood, or with a change under trial), optionally followed by
``:-DNAME[=VALUE],...`` compiler switches. With no argument it takes the
checkout's own source. All are built with nvcc in parallel
(``variant_harness.py``), then each is held against the port's plain
backward (dx to 2 bf16 ulps of its largest element, dw, da and db to
2e-4 of theirs) and timed with CUDA events (mean of 20 calls after 3,
the kernels and their reductions) at each of ResNet-50's twelve K7
shapes at batch 256, the variants in turn at each shape; the last line
sums each variant's times over a training step's 32 launches. Shapes
that take the one pass (``k7_bwd_plan``) are also timed as three passes
(``/3p``), which the entry point takes at any shape. The last variant's
device ms by part (one pass; dyc, dx, dw; reductions) follow each shape,
from a torch.profiler window (``chip_smoke.py``'s kernel names). Run
from the repository root on the card:

    python3 scripts/k7_bwd_variants.py [SOURCE.cu[:-DFLAG,...] ...]
"""

from __future__ import annotations

import ctypes
import sys
import tempfile

import torch

from variant_harness import (CSRC_DIR, ClockSampler, build_all, card,
                             spec_name, time_ms)

from chip_smoke import device_events, resnet_part
from paddle_tpu_torch.ops.hopper import resnet_unit as ru

# (rows, cin, cout, prologue, launches a step): per layer, unit a of the
# first block (at the layer's input rows), unit a of the others, unit b
SHAPES = [(802816, 64, 64, False, 1), (802816, 256, 64, False, 2),
          (802816, 64, 256, True, 3),
          (802816, 256, 128, False, 1), (200704, 512, 128, False, 3),
          (200704, 128, 512, True, 4),
          (200704, 512, 256, False, 1), (50176, 1024, 256, False, 5),
          (50176, 256, 1024, True, 6),
          (50176, 1024, 512, False, 1), (12544, 2048, 512, False, 2),
          (12544, 512, 2048, True, 3)]
DX_REL, SUM_REL = 2.0 ** -7, 2e-4
# resnet_unit_bwd: x, w, a, b, dy, gs1, gs2, dyc, dx, part_dx, dadb,
# part_dw, dw, M, cin, cout, ctas, sms, splits, ksplit, stream
ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def parts_ms(call, iters=5):
    """Device ms per call of each part of K7's backward."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    parts = {}
    for name, dev_us in device_events(prof)[0].items():
        part = resnet_part(name) or name[:40]
        parts[part] = parts.get(part, 0.0) + dev_us / 1e3 / iters
    return " ".join(f"{k}={v * 1e3:.1f}us" for k, v in sorted(parts.items()))


def main() -> int:
    if not torch.cuda.is_available():
        print("k7_bwd_variants: needs a CUDA device", file=sys.stderr)
        return 2
    specs = sys.argv[1:] or [str(CSRC_DIR / "resnet_unit.cu")]
    with tempfile.TemporaryDirectory() as out_dir:
        fns = [fn for fn, _ in build_all(specs, out_dir, "resnet_unit_bwd",
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
        dy = torch.randn(rows, cout, device="cuda", generator=gen).bfloat16()
        gs1 = torch.randn(cout, device="cuda", generator=gen) * 1e-3
        gs2 = torch.randn(cout, device="cuda", generator=gen) * 1e-5
        want = ru.conv1x1_bn_bwd_reference(x, w, a, b, dy, gs1, gs2)
        plans = [("", ru.k7_bwd_plan(rows, cin, cout, pro, sms))]
        if plans[0][1]["design"] == "one_pass":
            plans.append(("/3p", ru.k7_bwd_plan(rows, cin, cout, pro, sms,
                                                one_pass=False)))
        stream = torch.cuda.current_stream().cuda_stream
        row = [f"{rows}x{cin}x{cout}{'+pro' if pro else ''} x{launches}:"]
        for spec, fn in zip(specs, fns):
            for tag, plan in plans:
                one = plan["design"] == "one_pass"
                ctas = plan["ctas"] if one else 0
                splits, ksplit = (0, 0) if one else (plan["splits"],
                                                     plan["ksplit"])
                dw_parts = plan["dw_parts"] if one else splits
                dx = torch.empty(rows, cin, device="cuda",
                                 dtype=torch.bfloat16)
                dyc = None if one else torch.empty_like(dy)
                # the da/db partials: one per CTA or, in the three passes,
                # up to one per 128-row tile (an earlier source's layout)
                part_dx = torch.empty(ctas if one else -(-rows // 128), 2,
                                      cin, device="cuda")
                dadb = torch.empty(2, cin, device="cuda")
                part_dw = torch.empty(dw_parts, cin, cout, device="cuda")
                dw = torch.empty(cin, cout, device="cuda")

                def ptr(t):
                    return None if t is None else t.data_ptr()

                def call():
                    return fn(x.data_ptr(), w.data_ptr(), ptr(a), ptr(b),
                              dy.data_ptr(), gs1.data_ptr(), gs2.data_ptr(),
                              ptr(dyc), dx.data_ptr(), part_dx.data_ptr(),
                              dadb.data_ptr(), part_dw.data_ptr(),
                              dw.data_ptr(), rows, cin, cout, ctas, sms,
                              splits, ksplit, stream)
                if call() != 0:
                    raise SystemExit(f"{spec}{tag}: launch failed")
                torch.cuda.synchronize()
                got = (dx, dw) + ((dadb[0], dadb[1]) if pro else ())
                for name, g, r in zip(("dx", "dw", "da", "db"), got, want):
                    rel = float((g.float() - r.float()).abs().max()
                                / r.float().abs().max())
                    if rel > (DX_REL if name == "dx" else SUM_REL):
                        raise SystemExit(f"{spec}{tag}: {name} disagrees "
                                         f"({rel})")
                ms = time_ms(call, 20, 3)
                if not tag:
                    step_ms[spec] = step_ms.get(spec, 0.0) + launches * ms
                    if spec == specs[-1]:
                        parts = parts_ms(call)
                row.append(f"{spec_name(spec)}{tag}={ms * 1e3:.1f}us")
                del dx, dyc, part_dx, part_dw
        print(" ".join(row), flush=True)
        print(f"  {spec_name(specs[-1])} by part: {parts}", flush=True)
        del x, w, dy, want
        torch.cuda.empty_cache()
    print("per training step (32 launches): " + " ".join(
        f"{spec_name(spec)}={ms:.3f}ms" for spec, ms in step_ms.items()))
    print(clocks.stop())
    return 0


if __name__ == "__main__":
    sys.exit(main())
