#!/usr/bin/env python3
"""Time variants of the flash forward (K1/K3) side by side on one card.

Each argument is a CUDA source with the same ``flash_fwd_launch`` entry
point as ``paddle_tpu_torch/csrc/flash_attention.cu`` (a copy of it as
it stood, or with a change under trial), optionally followed by
``:-DNAME[=VALUE],...`` compiler switches. With no argument it takes the
checkout's own source. All are built with nvcc in parallel
(``variant_harness.py``), then each is held against the port's plain
forward (out to 4 bf16 ulps of each row's largest element, lse to
1e-4) and timed with CUDA events (mean of 50 calls after 10; nothing
else is launched inside a timed call), beside SDPA on the
same inputs, at the training shape, the GQA, d=64 and non-causal cases
of ``chip_smoke.py`` and a non-causal case at the training length
(every q tile of equal length), bf16. Each case times the variants in
turn, then again in reverse order. One large ``torch.matmul`` gives the
card's current product rate as a yardstick, and the SM clock and power
draw are sampled over the run (``nvidia-smi``). Run from the repository
root on the card:

    python3 scripts/flash_fwd_variants.py [--time-only] \
        [SOURCE.cu[:-DFLAG,...] ...]

``--time-only`` skips the check, for diagnostic builds that leave work
out on purpose (their outputs are wrong); their times are marked so.
"""

from __future__ import annotations

import ctypes
import sys
import tempfile

import torch
from torch.nn.functional import scaled_dot_product_attention as sdpa

from variant_harness import (CSRC_DIR, ClockSampler, build_all, card,
                             spec_name, time_ms)

from paddle_tpu_torch.ops.hopper import flash_attention as fa

# (name, b, sq, sk, h, kv, d, causal)
CASES = [
    ("causal_b2_s4096_h32_d128", 2, 4096, 4096, 32, 32, 128, True),
    ("gqa_h32_kv8_s2048", 1, 2048, 2048, 32, 8, 128, True),
    ("d64_g1_s1024_h16", 1, 1024, 1024, 16, 16, 64, True),
    ("noncausal_sq256_sk1024", 2, 256, 1024, 32, 32, 128, False),
    ("noncausal_b1_s4096_h32_d128", 1, 4096, 4096, 32, 32, 128, False),
]
OUT_REL = 2.0 ** -6
LSE_ATOL = 1e-4
# flash_fwd_launch: q, k, v, out, lse, strides, B, H, KV, sq, sk, d,
# dtype, causal, scale, group, stream
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = ([_P] * 5 + [ctypes.POINTER(ctypes.c_longlong)] + [_I] * 8
            + [ctypes.c_float, _I, _P])


def ptxas_lines(src_name, log):
    """The compiler's lines about the bf16 forward kernel, and warnings."""
    kernel = ""
    for line in log.splitlines():
        if "Compiling entry" in line or "Function properties" in line:
            kernel = line
        elif ("flash_fwd_kernel_bf16" in kernel
              or any(w in line for w in ("arning", "C75", "Performance"))):
            print(f"{src_name} {kernel.split('ILi')[-1][:3]}: "
                  f"{line.strip()}")


def rows_ok(out, want):
    """Every row of out within OUT_REL of that row's largest |want|."""
    err = (out.float() - want.float()).abs().amax(-1)
    return bool((err <= OUT_REL * want.float().abs().amax(-1)).all())


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_fwd_variants: needs a CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    checked = "--time-only" not in args
    specs = [a for a in args if a != "--time-only"] or [
        str(CSRC_DIR / "flash_attention.cu")]
    names = [spec_name(s) for s in specs]
    with tempfile.TemporaryDirectory() as out_dir:
        built = build_all(specs, out_dir, "flash_fwd_launch", ARGTYPES)
        for name, (_, log) in zip(names, built):
            ptxas_lines(name, log)
        fns = [fn for fn, _ in built]
    print(card(), flush=True)
    clocks = ClockSampler()
    # yardstick: what one large bf16 product reaches on this card now
    a = torch.randn(8192, 8192, device="cuda").bfloat16()
    mm_ms = time_ms(lambda: a @ a, 50, 10)
    print(f"torch.matmul bf16 8192^3: {mm_ms * 1e3:.1f}us = "
          f"{2 * 8192 ** 3 / mm_ms / 1e9:.1f} TFLOP/s", flush=True)
    del a
    gen = torch.Generator(device="cuda").manual_seed(4321)
    for cname, b, sq, sk, h, kv, d, causal in CASES:
        q, k, v = (torch.randn(b, n, heads, d, device="cuda",
                               generator=gen).bfloat16()
                   for n, heads in ((sq, h), (sk, kv), (sk, kv)))
        scale = d ** -0.5
        want, want_lse = fa.flash_attention_fwd_reference(q, k, v, causal,
                                                          scale)
        out = torch.empty_like(q)
        lse = torch.empty(b, h, sq, device="cuda")
        strides = fa._strides(q, k, v)
        group = fa.fwd_group(b, h, kv, sk, d)
        stream = torch.cuda.current_stream().cuda_stream
        calls = []
        for name, fn in zip(names, fns):
            def call(fn=fn):
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), lse.data_ptr(), strides, b, h, kv,
                          sq, sk, d, 1, int(causal), scale, group, stream)
            if call() != 0:
                raise SystemExit(f"{name}: launch failed")
            torch.cuda.synchronize()
            lerr = float((lse - want_lse).abs().max())
            if checked and not (rows_ok(out, want) and lerr <= LSE_ATOL):
                raise SystemExit(f"{name} {cname}: out beyond {OUT_REL} of "
                                 f"a row's largest value, or lse err {lerr}")
            calls.append(call)
        g = h // kv
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (
            q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
        names_all = names + ["sdpa"]
        calls.append(lambda: sdpa(qt, kt, vt, is_causal=causal))
        us = {n: [] for n in names_all}
        for order in (range(len(names_all)),
                      reversed(range(len(names_all)))):
            for j in order:
                us[names_all[j]].append(time_ms(calls[j], 50, 10) * 1e3)
        print(f"{cname}{'' if checked else ' (unchecked)'}: " + " ".join(
            f"{n}={'/'.join(f'{t:.1f}' for t in us[n])}us"
            for n in names_all), flush=True)
    print(clocks.stop())
    return 0


if __name__ == "__main__":
    sys.exit(main())
