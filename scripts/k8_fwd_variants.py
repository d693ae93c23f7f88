#!/usr/bin/env python3
"""Time variants of K8's forward band kernel side by side on one card.

Each argument is a CUDA source with the same ``conv3x3_bn_fwd`` entry
point as ``paddle_tpu_torch/csrc/conv3x3_bn.cu`` (a copy of it as it
stood, or with a change under trial), optionally followed by
``:-DNAME[=VALUE],...`` compiler switches. With no argument it takes the
checkout's own source. All are built with nvcc in parallel
(``variant_harness.py``), then each is held against the port's plain
forward (y to 2 bf16 ulps of its largest element) and timed with CUDA events (mean of 20 calls after 3, entry
point and statistics reduction) at ResNet-50's three stride-1 3x3 shapes
at batch 256, the variants in turn at each shape. Run from the
repository root on the card:

    python3 scripts/k8_fwd_variants.py [SOURCE.cu[:-DFLAG,...] ...]
"""

from __future__ import annotations

import ctypes
import sys
import tempfile

import torch

from variant_harness import (CSRC_DIR, build_all, card, spec_name,
                             time_ms)

from paddle_tpu_torch.ops.hopper import resnet_unit as ru

SHAPES = [(256, 56, 56, 64), (256, 28, 28, 128), (256, 14, 14, 256)]
Y_REL = 2.0 ** -7
# conv3x3_bn_fwd: x, w9, a, b, y, part, stats, n, h, w, cin, cout, rows,
# cols, groups, stream
ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def main() -> int:
    if not torch.cuda.is_available():
        print("k8_fwd_variants: needs a CUDA device", file=sys.stderr)
        return 2
    specs = sys.argv[1:] or [str(CSRC_DIR / "conv3x3_bn.cu")]
    with tempfile.TemporaryDirectory() as out_dir:
        fns = [fn for fn, _ in build_all(specs, out_dir, "conv3x3_bn_fwd",
                                         ARGTYPES)]
    print(card())
    gen = torch.Generator(device="cuda").manual_seed(2024)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, h, w, c in SHAPES:
        x = torch.randn(n, h, w, c, device="cuda", generator=gen).bfloat16()
        w9 = (torch.randn(9, c, c, device="cuda", generator=gen)
              * (9 * c) ** -0.5).bfloat16()
        a = torch.rand(c, device="cuda", generator=gen) + 0.5
        b = torch.randn(c, device="cuda", generator=gen) * 0.5
        want = ru.conv3x3_bn_fwd_reference(x, w9, a, b)[0].float()
        plan = ru.conv3_fwd_work_split(n, h, w, c, c, sms)
        stream = torch.cuda.current_stream().cuda_stream
        row = [f"{n}x{h}x{w}x{c}:"]
        for spec, fn in zip(specs, fns):
            y = torch.empty(n, h, w, c, device="cuda", dtype=torch.bfloat16)
            part = torch.empty(plan["groups"], 2, c, device="cuda")
            stats = torch.empty(2, c, device="cuda")

            def call():
                return fn(x.data_ptr(), w9.data_ptr(), a.data_ptr(),
                          b.data_ptr(), y.data_ptr(), part.data_ptr(),
                          stats.data_ptr(), n, h, w, c, c, plan["rows"],
                          plan["cols"], plan["groups"], stream)
            if call() != 0:
                raise SystemExit(f"{spec}: launch failed")
            torch.cuda.synchronize()
            rel = float((y.float() - want).abs().max() / want.abs().max())
            if rel > Y_REL:
                raise SystemExit(f"{spec}: y disagrees ({rel})")
            row.append(f"{spec_name(spec)}={time_ms(call, 20, 3) * 1e3:.1f}us")
        print(" ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
