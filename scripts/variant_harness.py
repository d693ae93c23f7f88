"""What the variant scripts (``flash_fwd_variants.py``,
``flash_bwd_variants.py``, ``k8_fwd_variants.py``,
``k7_bwd_variants.py``) share: build CUDA sources side by side with
``nvcc`` in parallel, time a call with CUDA events, and read the card's
name, power limit and SM clock from ``nvidia-smi``.

A source is given as ``SOURCE.cu[:-DNAME[=VALUE],...]``: a copy of one of
the port's sources (as it stood, or with a change under trial) and
optional compiler switches. Headers resolve from the copy's own folder,
then from ``paddle_tpu_torch/csrc``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from paddle_tpu_torch.ops.hopper._build import (  # noqa: E402
    CSRC_DIR, NVCC_FLAGS, find_nvcc)


def _build_one(index, spec, out_dir, entry, argtypes):
    src, _, flags = spec.partition(":")
    out = os.path.join(out_dir, f"lib{index}.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, f"-I{CSRC_DIR}",
           *[f for f in flags.split(",") if f], "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"{spec}: nvcc failed\n{proc.stdout}{proc.stderr}")
    fn = getattr(ctypes.CDLL(out), entry)
    fn.argtypes = argtypes
    return fn, proc.stdout + proc.stderr


def build_all(specs, out_dir, entry, argtypes):
    """Build every source spec into ``out_dir`` at once (one nvcc each).
    Returns ``[(entry point, compiler log), ...]`` in the specs' order;
    a failed build exits with the compiler's output."""
    with ThreadPoolExecutor() as ex:
        return list(ex.map(
            lambda i: _build_one(i, specs[i], out_dir, entry, argtypes),
            range(len(specs))))


def spec_name(spec):
    """A short label: the source's file name and its switches."""
    src, _, flags = spec.partition(":")
    return os.path.basename(src) + flags


def time_ms(fn, iters, warmup):
    """Mean ms of ``fn`` over ``iters`` calls after ``warmup``, CUDA
    events around the whole run."""
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


def card():
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


class ClockSampler:
    """Samples the SM clock and power draw every 200 ms while it runs
    (``nvidia-smi -lms``); :meth:`stop` ends it and summarises the
    samples taken under load."""

    def __init__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader", "-lms", "200"], stdout=subprocess.PIPE,
            text=True)

    def stop(self, busy_watts=150.0):
        self.proc.terminate()
        rows = [line.split(",") for line in
                self.proc.communicate()[0].split("\n") if line.strip()]
        watts = [float(r[1].split()[0]) for r in rows]
        busy = sorted(float(r[0].split()[0]) for r, w in zip(rows, watts)
                      if w > busy_watts)
        return (f"clocks.sm MHz while drawing over {busy_watts:g} W "
                f"({len(busy)} samples): min {busy[0] if busy else None} "
                f"median {busy[len(busy) // 2] if busy else None}; "
                f"power.draw W: max {max(watts) if watts else None}")
