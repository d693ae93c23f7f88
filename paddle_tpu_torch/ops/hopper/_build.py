"""Build the port's CUDA sources into shared libraries with ``nvcc``.

Each library is compiled from ``paddle_tpu_torch/csrc`` into the
checkout's ``build/`` directory, on first use, keyed by a hash of its
sources, of every header under ``csrc/`` (``*.cuh``, which the sources
include) and of the flags: a changed source or header builds anew, an
unchanged one is loaded from the earlier build. The sources have a
plain C interface and include no PyTorch header, so a build takes
seconds; the wrappers load the library with ``ctypes``. A failed build
raises with the compiler's output.

:func:`count_launch` is the one place a wrapper adds to its launch count
(``<wrapper>.launches``, and ``<wrapper>.launches_by_form`` where its
kernels come in several forms), and :func:`reset_launches` the one place
both are set to 0, under a lock: replicas of a serving fleet step on
threads of their own, and a bare ``+= 1`` from two threads can lose a
count.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"

# sm_90a keeps wgmma/setmaxnreg available to later kernels; -Xptxas -v
# reports registers, shared memory and spills in the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper, form=None, kernels=1) -> None:
    """Add ``kernels`` (the kernels one call launched) to
    ``wrapper.launches``, exactly under threads; with ``form``, also to
    ``wrapper.launches_by_form[form]``, for a wrapper whose kernels come
    in several forms (input type, head width)."""
    with _LAUNCH_LOCK:
        wrapper.launches += kernels
        if form is not None:
            by = wrapper.launches_by_form
            by[form] = by.get(form, 0) + kernels


def reset_launches(*wrappers) -> None:
    """Set every count of ``wrappers`` to 0: ``launches`` and, where a
    wrapper has one, ``launches_by_form``."""
    with _LAUNCH_LOCK:
        for w in wrappers:
            w.launches = 0
            if hasattr(w, "launches_by_form"):
                w.launches_by_form = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels build from source")


def library_path(name: str, sources: list[str], csrc: Path = CSRC_DIR,
                 build: Path = BUILD_DIR) -> Path:
    """``build/lib<name>-<hash>.so``: the hash covers the flags, the
    sources (file names under ``csrc``) and every ``*.cuh`` header
    there."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [csrc / s for s in sources] + sorted(csrc.glob("*.cuh")):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    return build / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_library(name: str, sources: list[str]) -> tuple[Path, str]:
    """Compile ``sources`` (file names under csrc/) into
    :func:`library_path`. Returns the library path and the compiler log
    ("" when an earlier build was reused)."""
    paths = [CSRC_DIR / s for s in sources]
    out = library_path(name, sources)
    if out.is_file():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a name private to this process and thread, and rename:
    # concurrent builders never write one file or load a half-written
    # library
    tmp = out.with_name(
        f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr
