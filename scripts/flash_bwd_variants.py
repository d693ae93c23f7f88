#!/usr/bin/env python3
"""Time variants of the flash backward (K2/K4: the dq and dkv kernels)
side by side on one card.

Each argument is a CUDA source with the same ``flash_bwd_launch`` entry
point as ``paddle_tpu_torch/csrc/flash_attention.cu`` (a copy of it as
it stood, or with a change under trial), optionally followed by
``:-DNAME[=VALUE],...`` compiler switches. With no argument it takes the
checkout's own source. All are built with nvcc in parallel
(``variant_harness.py``), then each is held against the port's plain
backward (dq, dk and dv to 8 bf16 ulps of each row's largest element,
that at least 2^-10 of the tensor's largest, as ``chip_smoke.py`` holds
them) and timed with CUDA events (dq and dkv apart, mean of 30 calls
after 5), beside SDPA's
backward on the same inputs, at the training shape and the GQA, d=64
and non-causal cases of ``chip_smoke.py``, bf16. Each case times the
variants in turn, then again in reverse order. The SM clock and power
draw are sampled over the run (``nvidia-smi``). Run from the repository
root on the card:

    python3 scripts/flash_bwd_variants.py [--time-only] \
        [SOURCE.cu[:-DFLAG,...] ...]

``--time-only`` skips the check, for diagnostic builds that leave work
out on purpose; their times are marked so.
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
]
REL = 2.0 ** -5
FLOOR = 2.0 ** -10
# flash_bwd_launch: q, k, v, dout, lse, delta, dq, dk, dv, strides, B, H,
# KV, sq, sk, d, dtype, causal, scale, which, group, stream
_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = ([_P] * 9 + [ctypes.POINTER(ctypes.c_longlong)] + [_I] * 8
            + [ctypes.c_float, _I, _I, _P])


def ptxas_lines(src_name, log):
    """The compiler's lines about the bf16 backward kernels, and
    warnings."""
    kernel = ""
    for line in log.splitlines():
        if "Compiling entry" in line or "Function properties" in line:
            kernel = line
        elif ("_kernel_bf16" in kernel and "fwd" not in kernel
              or any(w in line for w in ("arning", "C75", "Performance"))):
            name = "dq" if "flash_dq" in kernel else "dkv"
            print(f"{src_name} {name} {kernel.split('ILi')[-1][:3]}: "
                  f"{line.strip()}")


def rows_ok(got, want):
    """Every row within REL of its largest |want|, at least FLOOR of the
    tensor's largest."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(-1)
    top = w.abs().amax(-1).clamp(min=FLOOR * float(w.abs().max()))
    return bool((err <= REL * top).all())


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_variants: needs a CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    checked = "--time-only" not in args
    specs = [a for a in args if a != "--time-only"] or [
        str(CSRC_DIR / "flash_attention.cu")]
    names = [spec_name(s) for s in specs]
    with tempfile.TemporaryDirectory() as out_dir:
        built = build_all(specs, out_dir, "flash_bwd_launch", ARGTYPES)
        for name, (_, log) in zip(names, built):
            ptxas_lines(name, log)
        fns = [fn for fn, _ in built]
    print(card(), flush=True)
    clocks = ClockSampler()
    gen = torch.Generator(device="cuda").manual_seed(4321)
    for cname, b, sq, sk, h, kv, d, causal in CASES:
        q, k, v, do = (torch.randn(b, n, heads, d, device="cuda",
                                   generator=gen).bfloat16()
                       for n, heads in ((sq, h), (sk, kv), (sk, kv), (sq, h)))
        scale = d ** -0.5
        out, lse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                                scale)
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        strides = fa._strides(q, k, v, do)
        groups = (fa.fwd_group(b, h, kv, sk, d), fa.dkv_group(b, h, kv, sq, d))
        stream = torch.cuda.current_stream().cuda_stream
        calls = {}
        for name, fn in zip(names, fns):
            for which in (0, 1):
                def call(fn=fn, which=which):
                    return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                              dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                              strides, b, h, kv, sq, sk, d, 1, int(causal),
                              scale, which, groups[which], stream)
                if call() != 0:
                    raise SystemExit(f"{name}: launch failed")
                calls[name, which] = call
            torch.cuda.synchronize()
            if checked and not all(rows_ok(g, w) for g, w in zip(
                    (dq, dk, dv), want)):
                raise SystemExit(f"{name} {cname}: dq, dk or dv beyond {REL}"
                                 f" of a row's largest value")
        g = h // kv
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k.repeat_interleave(g, 2),
                                v.repeat_interleave(g, 2)))
        lib_out = sdpa(qt, kt, vt, is_causal=causal)
        dot = do.transpose(1, 2).contiguous()
        labels = [(n, w) for n in names for w in (0, 1)] + ["sdpa"]
        calls["sdpa"] = lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True)
        us = {x: [] for x in labels}
        for order in (labels, labels[::-1]):
            for x in order:
                us[x].append(time_ms(calls[x], 30, 5) * 1e3)
        fmt = "/".join
        print(f"{cname}{'' if checked else ' (unchecked)'}: " + " ".join(
            f"{n}=dq {fmt(f'{t:.1f}' for t in us[n, 0])} dkv "
            f"{fmt(f'{t:.1f}' for t in us[n, 1])} pair "
            f"{fmt(f'{a + c:.1f}' for a, c in zip(us[n, 0], us[n, 1]))}us"
            for n in names)
            + f" sdpa_bwd={fmt(f'{t:.1f}' for t in us['sdpa'])}us",
            flush=True)
        del q, k, v, do, out, lse, delta, want, dq, dk, dv, qt, kt, vt
        del lib_out, dot
        torch.cuda.empty_cache()
    print(clocks.stop())
    return 0


if __name__ == "__main__":
    sys.exit(main())
