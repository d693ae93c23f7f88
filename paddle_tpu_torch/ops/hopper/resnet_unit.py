"""Fused conv + BatchNorm: the Hopper kernels K7 (1x1 conv) and K8 (3x3
conv), their plain versions, and the autograd Functions around them.

Replaces the Pallas TPU kernels of ``paddle_tpu/ops/pallas/resnet_unit.py``:
``fused_conv1x1_bn`` (K7: ``_fwd_kernel`` via ``_fwd_impl``, ``_bwd_kernel``
via ``_bwd_impl``) and ``fused_conv3x3_bn`` (K8: ``_conv3_fwd_kernel``,
``_conv3_bwd_kernel``). The kernels are CUDA C++ for ``sm_90a`` in
``paddle_tpu_torch/csrc/resnet_unit.cu`` (K7) and
``paddle_tpu_torch/csrc/conv3x3_bn.cu`` (K8, both directions, on bands
of whole image rows), built with ``nvcc`` on first use and called
through ``ctypes``; each source's header note says how its kernels
work.

Forward, over NHWC rows: ``xn = relu(x * a + b)`` rounded to x's dtype
(the optional prologue: the previous BatchNorm's f32 scale and shift),
``y = conv(xn, w)`` with f32 accumulation, and the BatchNorm statistics
``s1 = sum_rows(y)``, ``s2 = sum_rows(y^2)`` taken from the f32
accumulator before y is rounded. Backward, with the statistics'
cotangents folded into dy: ``dyc = round(dy + gs1 + 2 y gs2)``,
``dw = xn^T dyc`` (f32, cast to w's dtype by the Function),
``dxn = dyc w^T``, and with a prologue ``du = dxn [u > 0]``,
``dx = round(du a)``, ``da = sum(du x)``, ``db = sum(du)``. K7's backward
recomputes y; K8's reads the saved y. The 3x3 conv pads ``xn`` with
zeros after the prologue, and its dxn correlates dyc with the flipped
taps.

What bounds them on an H100: the 1x1 convs of ResNet-50's first stage
(64 and 256 channels) do too few operations per byte and are bound by
bytes, as is the 3x3 conv at 64 channels; the wide 1x1 convs and the
wider 3x3 convs are bound by operations.
The kernels read each activation once per product, keep xn and the
statistics out of device memory, and replace the TPU kernels' sums
carried through a sequential grid with per-CTA partials and a second,
deterministic pass (no atomics).

The plain versions (``*_reference``) repeat the kernels' arithmetic in
PyTorch, rounding where they round, and take float32 too (the CPU tests
compare them with the JAX functions in f32). A CPU tensor runs them; a
CUDA tensor launches the kernels (bfloat16 only) or raises, and never
falls back.

``supported`` and ``supported_3x3`` are the JAX package's routing
predicates, copied so that the same blocks take the same route in both
packages.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import build_library

_SOURCES = ["resnet_unit.cu"]
_CONV3_SOURCES = ["conv3x3_bn.cu"]
_ROW_TILE = 128     # rows of a CTA tile in the kernels' row GEMMs
_MAX_ROW_TILES = 65535

# K8 works on bands (conv3x3_bn.cu): 64-channel tiles of 128-byte
# shared-memory rows, at most 256 positions a band for the two warpgroups
# of the forward and dx kernels, within the shared memory a block may opt
# into on an H100 less 5 KB for the kernels' static shared memory
_C3_TILE = 64
_C3_ROW_BYTES = 128
_C3_MAX_M = 256
_C3_SMEM = 232448 - 5120
_C3_W_BYTES = 9 * _C3_TILE * _C3_TILE * 2


# -- routing predicates (copied from the JAX package) -----------------------

def supported(rows, cin, cout):
    """Shapes the fused 1x1 path takes: channel counts that are multiples
    of 128 or the stage-1 width 64, and rows in whole 128-row tiles."""

    def ok_c(c):
        return c % 128 == 0 or c == 64
    return ok_c(cin) and ok_c(cout) and rows % 128 == 0


_VMEM_BUDGET = 34 * 1024 * 1024


def _conv3_bn(n, h, w, cin, cout):
    """Images per grid step of the TPU kernel, 0 when one image does not
    fit its VMEM budget. A TPU detail, kept only as the routing predicate
    of ``supported_3x3`` (so that the same blocks take K8 in both
    packages); the CUDA kernels do not depend on it."""
    fixed = 9 * cin * cout * 6
    per_img = h * w * (cin + cout) * 40
    bn = 1
    if fixed + per_img > _VMEM_BUDGET:
        return 0
    for cand in (2, 4, 8, 16, 32, 64):
        if n % cand or cand * h * w > 8192:
            break
        if fixed + cand * per_img > _VMEM_BUDGET:
            break
        bn = cand
    return bn


def supported_3x3(n, h, w, cin, cout):
    """Shapes the fused 3x3 path (K8) takes."""
    if cin % 128 and cin != 64:
        return False
    if cout % 128 and cout != 64:
        return False
    return h * w >= 128 and h >= 4 and _conv3_bn(n, h, w, cin, cout) > 0


# -- plain versions ----------------------------------------------------------

def _prologue(x, a, b):
    """(xn in x's dtype, u > 0 or None): ``relu(x * a + b)`` in f32."""
    if a is None:
        return x, None
    u = x.float() * a.float() + b.float()
    return torch.clamp_min(u, 0.0).to(x.dtype), u > 0


def _stats(y32):
    return y32.sum(0), (y32 * y32).sum(0)


def _mask_grads(dxn, x, a, mask):
    """dx, da, db from dxn through the prologue (dx alone without one)."""
    if mask is None:
        return dxn.to(x.dtype), None, None
    du = torch.where(mask, dxn, torch.zeros((), device=dxn.device))
    dx = (du * a.float()).to(x.dtype)
    return dx, (du * x.float()).sum(0), du.sum(0)


def conv1x1_bn_fwd_reference(x2d, w, a=None, b=None):
    """Plain K7 forward: ``x2d [rows, cin]``, ``w [cin, cout]``, optional
    ``a, b [cin]``. Returns (y in x's dtype, s1 f32 [cout], s2 f32)."""
    xn, _ = _prologue(x2d, a, b)
    y32 = xn.float() @ w.float()
    s1, s2 = _stats(y32)
    return y32.to(x2d.dtype), s1, s2


def conv1x1_bn_bwd_reference(x2d, w, a, b, gy, gs1, gs2):
    """Plain K7 backward: (dx in x's dtype, dw f32 [cin, cout], da, db f32
    [cin] or None without a prologue)."""
    xn, mask = _prologue(x2d, a, b)
    y32 = xn.float() @ w.float()
    dyc = (gy.float() + gs1.float() + 2.0 * y32 * gs2.float()).to(gy.dtype)
    dw = xn.float().t() @ dyc.float()
    dxn = dyc.float() @ w.float().t()
    dx, da, db = _mask_grads(dxn, x2d, a, mask)
    return dx, dw, da, db


def _taps(v):
    """The nine shifted views of NHWC ``v`` padded by one (tap
    t = 3 di + dj reads (i + di - 1, j + dj - 1)), each as rows."""
    n, h, w, c = v.shape
    vp = F.pad(v, (0, 0, 1, 1, 1, 1))
    return [vp[:, di:di + h, dj:dj + w, :].reshape(n * h * w, c)
            for di in range(3) for dj in range(3)]


def conv3x3_bn_fwd_reference(x, w9, a, b):
    """Plain K8 forward: ``x [n, h, w, cin]``, ``w9 [9, cin, cout]``
    (tap-major), ``a, b [cin]``. The halo is zero in xn, after the
    prologue. Returns (y [n, h, w, cout] in x's dtype, s1, s2 f32)."""
    n, h, wd, _ = x.shape
    cout = w9.shape[-1]
    xn, _ = _prologue(x, a, b)
    y32 = sum(xs.float() @ w9[t].float() for t, xs in enumerate(_taps(xn)))
    s1, s2 = _stats(y32)
    return y32.to(x.dtype).reshape(n, h, wd, cout), s1, s2


def conv3x3_bn_bwd_reference(x, w9, a, b, y, gy, gs1, gs2):
    """Plain K8 backward from the saved forward output ``y``: (dx
    [n, h, w, cin] in x's dtype, dw f32 [9, cin, cout], da, db f32)."""
    n, h, wd, cin = x.shape
    cout = w9.shape[-1]
    xn, mask = _prologue(x, a, b)
    dyc = (gy.float() + gs1.float() + 2.0 * y.float() * gs2.float()
           ).to(gy.dtype)
    dy2d = dyc.reshape(-1, cout).float()
    dw = torch.stack([xs.float().t() @ dy2d for xs in _taps(xn)])
    # the correlation with the flipped taps: tap t = 3 di + dj reads dyc
    # at (i - di + 1, j - dj + 1), the view of tap 8 - t
    flipped = _taps(dyc)[::-1]
    dxn = sum(ds.float() @ w9[t].float().t() for t, ds in enumerate(flipped))
    dx, da, db = _mask_grads(dxn, x.reshape(-1, cin), a,
                             None if mask is None else mask.reshape(-1, cin))
    return dx.reshape(n, h, wd, cin), dw, da, db


# -- the kernels -------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    path, _ = build_library("resnet_unit", _SOURCES)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.resnet_unit_fwd.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.resnet_unit_fwd.restype = i
    lib.resnet_unit_bwd.argtypes = [p] * 13 + [i] * 7 + [p]
    lib.resnet_unit_bwd.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _conv3_library():
    path, _ = build_library("conv3x3_bn", _CONV3_SOURCES)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv3x3_bn_fwd.argtypes = [p] * 7 + [i] * 8 + [p]
    lib.conv3x3_bn_fwd.restype = i
    lib.conv3x3_bn_bwd.argtypes = [p] * 14 + [i] * 9 + [p]
    lib.conv3x3_bn_bwd.restype = i
    return lib


def build() -> str:
    """Build (or reuse) K7's library now; returns the compiler log (""
    when an earlier build was reused)."""
    _, log = build_library("resnet_unit", _SOURCES)
    _library()
    return log


def build_conv3x3() -> str:
    """Build (or reuse) K8's library (forward and backward) now; returns
    the compiler log ("" when an earlier build was reused)."""
    _, log = build_library("conv3x3_bn", _CONV3_SOURCES)
    _conv3_library()
    return log


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda(named, prologue_needed=False):
    """Raise unless every tensor of ``named`` (name -> tensor or None)
    lies on one CUDA device, is contiguous and starts on 16 bytes; the
    activations and weights must be bfloat16, the prologue and
    cotangents float32."""
    devs = {t.device for t in named.values() if t is not None}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"all tensors must lie on one CUDA device, got "
                         f"{sorted(map(str, devs))}")
    for name, t in named.items():
        if t is None:
            continue
        want = (torch.float32 if name in ("a", "b", "gs1", "gs2")
                else torch.bfloat16)
        if t.dtype != want:
            raise ValueError(f"{name}: the kernels take {want}, got "
                             f"{t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    if (named.get("a") is None) != (named.get("b") is None):
        raise ValueError("pass both a and b, or neither")
    if prologue_needed and named.get("a") is None:
        raise ValueError("the 3x3 kernel needs the prologue a, b")


def _check_channels(rows, cin, cout):
    if cin % 64 or cout % 64 or cin < 64 or cout < 64:
        raise ValueError(f"channels {cin} -> {cout}: the kernels take "
                         f"multiples of 64")
    if rows < 1 or -(-rows // _ROW_TILE) > _MAX_ROW_TILES:
        raise ValueError(f"{rows} rows: the kernels take 1 to "
                         f"{_ROW_TILE * _MAX_ROW_TILES}")


def _launch_fwd(x, w, a, b, rows, cin, cout):
    """K7's forward as ``k7_fwd_plan`` says, then the sum of its s1/s2
    partials."""
    dev = x.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = k7_fwd_plan(rows, cin, cout, a is not None, sms)
    y = torch.empty((rows, cout), device=dev, dtype=torch.bfloat16)
    part = torch.empty((plan["parts"], 2, cout), device=dev,
                       dtype=torch.float32)
    stats = torch.empty((2, cout), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().resnet_unit_fwd(
            x.data_ptr(), w.data_ptr(), _ptr(a), _ptr(b), y.data_ptr(),
            part.data_ptr(), stats.data_ptr(), rows, cin, cout, sms, stream)
    if rc != 0:
        raise RuntimeError(f"resnet_unit forward launch failed: CUDA error "
                           f"{rc}")
    return y, stats[0], stats[1]


# -- K7: the plans -----------------------------------------------------------
#
# resnet_unit.cu mirrors these: the forward's kernel and the
# backward's two designs (its header note says how each works), the tiles
# and stages of each kernel, and the shared memory a block takes (dynamic
# from a 1024-byte boundary, plus static).

_SMEM_BLOCK = 232448         # shared memory an H100 block can use
_ROW_STAGES = 4              # k7_rows_kernel's ring of 64-wide chunks
_BWD_DW_ROWS = 64            # rows of a k7_dw_kernel chunk
_BWD_DW_STAGES = 4
_BARRIERS = 8 * 16           # the kernels' mbarriers, rounded up


def k7_onepass_takes(cin, cout, prologue):
    """Whether K7's backward runs as one pass: w and a warpgroup's half
    of dw fit (one channel count 64, the other 64, 128 or 256: w in 32 KB
    of shared memory, half of dw in at most 64 registers a thread; the
    64-wide one makes y or dx a single 64 x 64 accumulator), with the
    prologue only at ``cin = 64``, where da and db stay in registers.
    ResNet-50's layer-1 1x1 convs (64 -> 64, 256 -> 64, 64 -> 256 with
    the prologue) take it."""
    return (min(cin, cout) == 64 and max(cin, cout) in (64, 128, 256)
            and (not prologue or cin == 64))


def _tile_n(c):
    return 128 if c % 128 == 0 else 64


def _rows_grid(n, bn, rows, sms):
    """k7_rows_kernel's persistent grid (resnet_unit.cu's rows_grid):
    every tile, or the most CTAs up to one per SM that is a multiple of
    the ``n / bn`` column tiles."""
    nt = n // bn
    tiles = nt * -(-rows // _ROW_TILE)
    return tiles if tiles <= sms else sms // nt * nt


def _rows_smem(bn, sums):
    """k7_rows_kernel's shared memory (bytes, static included) at tile
    width ``bn``: the ring, two tiles' epilogue buffers and, where it
    keeps column sums (s1/s2, da/db), their reduction over warps."""
    return (1024 + _ROW_STAGES * (_ROW_TILE * 128 + 64 * bn * 2)
            + 2 * _ROW_TILE * bn * 2 + (8 if sums else 1) * 2 * bn * 4
            + _BARRIERS)


def k7_fwd_plan(rows, cin, cout, prologue, sms):
    """K7's forward at one shape (resnet_unit.cu's launch_fwd):
    k7_rows_kernel in 128 x ``bn`` tiles (``bn`` = 128 where it divides
    cout, else 64) on ``_rows_grid``'s persistent grid of ``ctas`` CTAs
    over ``nt`` column tiles (CTA k takes the tiles k, k + ctas, ..., all
    in column tile k % nt), ``parts`` s1/s2 partials (one per CTA of a
    column tile; partial p owns the 128-row tiles p, p + parts, ...), and
    its shared memory (bytes, static included). Neither cin nor the
    prologue changes the plan."""
    del cin, prologue
    bn = _tile_n(cout)
    ctas = _rows_grid(cout, bn, rows, sms)
    return dict(bn=bn, nt=cout // bn, ctas=ctas, parts=ctas // (cout // bn),
                smem=_rows_smem(bn, True))


def conv1x1_bn_fwd_tiles_reference(x2d, w, a=None, b=None, *, sms):
    """K7's forward the kernels' way, in plain PyTorch, for the tests:
    128-row tiles (the last one padded with zero rows, as TMA fills it),
    the prologue applied to every row of a tile, y from the f32 products,
    s1/s2 per partial k of ``k7_fwd_plan``'s over its tiles k, k + parts,
    ... with the rows past the end left out (with the prologue their y is
    relu(b) w, not zero), and the partials summed in bwd_reduce_kernel's
    order. Same contract as :func:`conv1x1_bn_fwd_reference`."""
    rows, cin = x2d.shape
    cout = w.shape[1]
    plan = k7_fwd_plan(rows, cin, cout, a is not None, sms)
    parts = plan["parts"]
    tiles = -(-rows // _ROW_TILE)
    y = torch.empty(rows, cout, dtype=x2d.dtype)
    part = torch.zeros(parts, 2, cout)
    for k in range(parts):
        for tile in range(k, tiles, parts):
            r0 = tile * _ROW_TILE
            here = min(_ROW_TILE, rows - r0)
            xs = F.pad(x2d[r0:r0 + here], (0, 0, 0, _ROW_TILE - here))
            y32 = _prologue(xs, a, b)[0].float() @ w.float()
            y[r0:r0 + here] = y32[:here].to(x2d.dtype)
            part[k, 0] += y32[:here].sum(0)
            part[k, 1] += (y32[:here] * y32[:here]).sum(0)
    s1, s2 = _col_reduce(part)
    return y, s1, s2


def k7_bwd_plan(rows, cin, cout, prologue, sms, one_pass=None):
    """K7's backward at one shape: the design (``k7_onepass_takes``, or
    ``one_pass`` where given: the three passes take any shape, which
    ``scripts/k7_bwd_variants.py`` uses to time both), and per design its
    tiles, each CTA's rows and the shared memory (bytes, static included)
    of each kernel.

    ``one_pass``: a persistent grid of ``ctas`` CTAs (at most one per SM
    and per 128-row tile); CTA k owns the contiguous 128-row tiles
    ``tile_ranges[k]``; ``dw_parts`` dw partials (two a CTA at 64 x 64,
    one per consumer warpgroup). ``three_pass``: the dyc and dx kernels'
    output tiles (128 x ``bn_dyc``, 128 x ``bn_dx``; persistent grids of
    ``dyc_ctas`` and ``dx_ctas`` CTAs, at most one per SM, which take the
    tiles in turn; ``dx_ctas`` a multiple of dx's column tiles, so that
    each CTA sums da/db over one column tile: ``dadb_parts`` partials),
    the dw kernel's
    ``dw_tile`` (cin x cout) and its split-K over rows: ``splits`` chunks
    of ``ksplit`` rows (a multiple of 64), about one CTA per SM over the
    dw tiles."""
    tiles = -(-rows // _ROW_TILE)
    if one_pass is None:
        one_pass = k7_onepass_takes(cin, cout, prologue)
    if one_pass:
        ctas = max(1, min(sms, tiles))
        static = (2 * cout + (2 * cin if prologue else 2)
                  + 2 * (8 if prologue else 1) * cin) * 4 + _BARRIERS
        return dict(
            design="one_pass", ctas=ctas,
            tile_ranges=[(k * tiles // ctas, (k + 1) * tiles // ctas)
                         for k in range(ctas)],
            dw_parts=2 * ctas if cin == cout == 64 else ctas,
            smem=dict(one_pass=1024 + cin * cout * 2
                      + 2 * _ROW_TILE * (cin + cout) * 2 + static))
    bn_dyc, bn_dx = _tile_n(cout), _tile_n(cin)
    dw_tile = (_tile_n(cin), _tile_n(cout))
    dw_tiles = (cin // dw_tile[0]) * (cout // dw_tile[1])
    want = max(1, sms // dw_tiles)
    ksplit = _up(-(-rows // want), _BWD_DW_ROWS)

    return dict(
        design="three_pass", bn_dyc=bn_dyc, bn_dx=bn_dx, dw_tile=dw_tile,
        dyc_ctas=_rows_grid(cout, bn_dyc, rows, sms),
        dx_ctas=_rows_grid(cin, bn_dx, rows, sms),
        dadb_parts=_rows_grid(cin, bn_dx, rows, sms) // (cin // bn_dx),
        splits=-(-rows // ksplit), ksplit=ksplit,
        smem=dict(dyc=_rows_smem(bn_dyc, False),
                  dx=_rows_smem(bn_dx, prologue),
                  dw=1024 + _BWD_DW_STAGES * _BWD_DW_ROWS
                  * (dw_tile[0] + dw_tile[1]) * 2 + _BARRIERS))


def _col_reduce(parts):
    """``parts.sum(0)`` in bwd_reduce_kernel's order, the one every
    partial of K7 is summed in: 8 row groups each sum their rows t = ty,
    ty + 8, ... in turn, then the group sums are added in order."""
    groups = []
    for ty in range(8):
        acc = torch.zeros_like(parts[0])
        for t in range(ty, parts.shape[0], 8):
            acc = acc + parts[t]
        groups.append(acc)
    out = groups[0]
    for acc in groups[1:]:
        out = out + acc
    return out


def conv1x1_bn_bwd_onepass_reference(x2d, w, a, b, gy, gs1, gs2, *, ctas):
    """K7's one-pass backward the kernel's way, in plain PyTorch, for the
    tests: CTA k of ``ctas`` walks its 128-row tiles (``k7_bwd_plan``'s
    ``tile_ranges``; the last tile may be short); per tile, y in 64-wide
    chunks of cout, each chunk's dyc rounded to gy's dtype before dx and
    dw use it, dx (through the mask) per tile; dw summed per CTA over its
    tiles (at 64 x 64 per consumer warpgroup: rows 0-63 and 64-127 of
    each tile apart), da/db per CTA; the partials summed in
    bwd_reduce_kernel's order. Same contract as
    :func:`conv1x1_bn_bwd_reference`."""
    rows, cin = x2d.shape
    cout = w.shape[1]
    plan = k7_bwd_plan(rows, cin, cout, a is not None, ctas)
    assert plan["design"] == "one_pass" and plan["ctas"] == ctas
    wf = w.float()
    dx = torch.empty_like(x2d)
    halves = 2 if cin == cout == 64 else 1
    part_dw = torch.zeros(ctas, halves, cin, cout)
    part_dx = torch.zeros(ctas, 2, cin)
    for k, (t0, t1) in enumerate(plan["tile_ranges"]):
        for tile in range(t0, t1):
            r0, r1 = tile * _ROW_TILE, min((tile + 1) * _ROW_TILE, rows)
            xs = x2d[r0:r1]
            xn, mask = _prologue(xs, a, b)
            xf = xn.float()
            dyc = torch.cat([
                (gy[r0:r1, c0:c0 + 64].float() + gs1[c0:c0 + 64].float()
                 + 2.0 * (xf @ wf[:, c0:c0 + 64]) * gs2[c0:c0 + 64].float()
                 ).to(gy.dtype) for c0 in range(0, cout, 64)], 1).float()
            dxs, da, db = _mask_grads(dyc @ wf.t(), xs, a, mask)
            dx[r0:r1] = dxs
            if a is not None:
                part_dx[k, 0] += da
                part_dx[k, 1] += db
            for hf in range(halves):
                lo, hi = (0, r1 - r0) if halves == 1 else (64 * hf, 64 * hf + 64)
                part_dw[k, hf] += xf[lo:hi].t() @ dyc[lo:hi]
    dw = _col_reduce(part_dw.reshape(-1, cin, cout))
    if a is None:
        return dx, dw, None, None
    da, db = _col_reduce(part_dx)
    return dx, dw, da, db


def _launch_bwd(x, w, a, b, gy, gs1, gs2, rows, cin, cout):
    """K7's backward as ``k7_bwd_plan`` says: the one pass (no dyc
    buffer), or the dyc, dx and split-K dw kernels; then the reductions."""
    dev = x.device
    pro = a is not None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = k7_bwd_plan(rows, cin, cout, pro, sms)
    f32 = dict(device=dev, dtype=torch.float32)
    dx = torch.empty((rows, cin), device=dev, dtype=torch.bfloat16)
    dadb = torch.empty((2, cin), **f32) if pro else None
    dw = torch.empty((cin, cout), **f32)
    if plan["design"] == "one_pass":
        ctas, splits, ksplit = plan["ctas"], 0, 0
        dyc = None
        part_dw = torch.empty((plan["dw_parts"], cin, cout), **f32)
        part_dx = torch.empty((ctas, 2, cin), **f32) if pro else None
    else:
        ctas, splits, ksplit = 0, plan["splits"], plan["ksplit"]
        dyc = torch.empty((rows, cout), device=dev, dtype=torch.bfloat16)
        part_dw = torch.empty((splits, cin, cout), **f32)
        part_dx = (torch.empty((plan["dadb_parts"], 2, cin), **f32)
                   if pro else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().resnet_unit_bwd(
            x.data_ptr(), w.data_ptr(), _ptr(a), _ptr(b), gy.data_ptr(),
            gs1.data_ptr(), gs2.data_ptr(), _ptr(dyc), dx.data_ptr(),
            _ptr(part_dx), _ptr(dadb), part_dw.data_ptr(), dw.data_ptr(),
            rows, cin, cout, ctas, sms, splits, ksplit, stream)
    if rc != 0:
        raise RuntimeError(f"resnet_unit backward launch failed: CUDA error "
                           f"{rc}")
    if pro:
        return dx, dw, dadb[0], dadb[1]
    return dx, dw, None, None


# -- K8: the band plan ----------------------------------------------------------
#
# conv3x3_bn.cu mirrors these: a band is ``rows`` image rows of one
# image (a piece of ``cols`` columns of them when the image is wide), kept
# in shared memory with a halo row above and below and a halo column on
# each side, so a band row holds ``cols + 2`` positions. Bands are
# numbered image-major, then down the image, then across it, and each CTA
# of a persistent grid takes a contiguous range of them.

def _up(v, m):
    return -(-v // m) * m


def conv3_band_geometry(rows, cols):
    """(pitch, computed, dx_computed, window) of a band of ``rows`` x
    ``cols``: the positions of a band row (``cols + 2``), the positions
    the dw kernel sums (``rows * pitch`` up to a multiple of 16) and the
    dx and forward kernels compute (up to a multiple of 64, wgmma's M;
    the pad columns are computed and discarded), and a window's slots
    (``dx_computed`` plus a halo row above and below and two more; the
    kernels add seven zero slots ahead of the window's box)."""
    pitch = cols + 2
    dx_computed = _up(rows * pitch, 64)
    return (pitch, _up(rows * pitch, 16), dx_computed,
            dx_computed + 2 * pitch + 2)


def conv3_smem(rows, cols, cout):
    """Dynamic shared memory (dw kernel, dx kernel) in bytes, with 1 KB to
    align the start to 1024 bytes. A window is chunk-major: 8 chunks of
    ``window + 7`` 16-byte slots, each rounded up to 128 bytes. dw keeps two
    stages of xn rows and a window, each stage rounded up to 1 KB; dx the
    nine 64 x 64 weight tiles (one resident copy at cout = 64, else one per
    stage) and two windows. The forward kernel keeps dx's layout with its
    chunks over cin: its shared memory is dx's at ``cout = cin``."""
    _, computed, _, window = conv3_band_geometry(rows, cols)
    chunk = _up((window + 7) * 16, 128)
    dw = 1024 + 2 * _up(computed * _C3_ROW_BYTES + 8 * chunk, 1024)
    dx = (1024 + (2 if cout > _C3_TILE else 1) * _C3_W_BYTES
          + 2 * 8 * chunk)
    return dw, dx


def _band_fits(rows, cols, cout):
    return conv3_band_geometry(rows, cols)[2] <= _C3_MAX_M and \
        max(conv3_smem(rows, cols, cout)) <= _C3_SMEM


@functools.lru_cache(maxsize=None)
def conv3_band_plan(h, w, cout):
    """(rows, cols) of K8's bands for ``h x w`` images, fitting the band
    kernels at ``cout`` channels (the forward takes it at cin). Whole
    image rows when they fit (the widest rows split into the fewest even
    pieces that do); of the row counts that fit, the one whose bands
    cost the dx kernel the fewest positions (each band computes whole
    64-position tiles, plus ~64 positions' worth of halo and set-up),
    the larger on a tie, evened out over the image: 56 rows of 56 -> 14
    bands of 4, 28 of 28 at 128 channels -> 5 of 6 (the last of 4), 14
    of 14 -> 1 of 14. Cached: the wrappers ask for it on every call."""
    pieces = 1
    while True:
        cols = -(-w // pieces)
        fits = [r for r in range(1, min(h, _C3_MAX_M // (cols + 2)) + 1)
                if _band_fits(r, cols, cout)]
        if fits:
            best = min(fits, key=lambda r: (
                -(-h // r) * (conv3_band_geometry(r, cols)[2] + 64), -r))
            return -(-h // -(-h // best)), cols
        pieces += 1


def conv3_bands(n, h, w, rows, cols):
    """Every band as (image, i0, rows here, j0, cols here), in the
    kernels' order; the last band down (across) an image may be short."""
    for img in range(n):
        for i0 in range(0, h, rows):
            for j0 in range(0, w, cols):
                yield img, i0, min(rows, h - i0), j0, min(cols, w - j0)


def group_bands(grp, groups, bands):
    """The bands of CTA ``grp`` of ``groups``: a contiguous range, sizes
    differing by at most one."""
    return range(grp * bands // groups, (grp + 1) * bands // groups)


def conv3_fwd_work_split(n, h, w, cin, cout, sms):
    """K8's forward work split: the band plan at ``cin`` (the forward's
    chunks run over cin, so the backward's plan at cout = cin fits its
    shared memory and positions) and the CTAs per 64-wide cout tile, so
    that the grid fills the SMs once."""
    rows, cols = conv3_band_plan(h, w, cin)
    bands = n * -(-h // rows) * -(-w // cols)
    return dict(rows=rows, cols=cols, bands=bands,
                groups=max(1, min(bands, sms // (cout // _C3_TILE))))


def conv3x3_bn_fwd_bands_reference(x, w9, a, b, *, rows, cols, groups):
    """K8's forward the band kernel's way, in plain PyTorch, for the
    tests: per band a window of ``rows + 2`` rows of ``cols + 2``
    positions from one halo row and column before the band (zero
    outside the image, as TMA fills it), the prologue applied only to
    the window's positions inside the image, output slot k summing tap
    t = 3 di + dj from window slot ``k + di (cols + 2) + dj`` (slot v
    holds window position v - 1; slot 0 is zero), the pad columns and
    the positions past a short band computed and discarded, and the
    statistics as one partial per group of bands (``group_bands``),
    summed in group order. Same contract as
    :func:`conv3x3_bn_fwd_reference`."""
    n, h, wd, cin = x.shape
    cout = w9.shape[2]
    pitch, _, computed, window = conv3_band_geometry(rows, cols)
    bands = list(conv3_bands(n, h, wd, rows, cols))
    w = w9.float()
    y = torch.zeros(n, h, wd, cout)
    part = torch.zeros(groups, 2, cout)
    rr = torch.arange(rows + 2)[:, None]
    cc = torch.arange(pitch)[None, :]
    for grp in range(groups):
        for band in group_bands(grp, groups, len(bands)):
            img, i0, here_r, j0, here_c = bands[band]
            i, j = i0 - 1 + rr, j0 - 1 + cc
            inside = ((i >= 0) & (i < h) & (j >= 0) & (j < wd))
            box = x[img, i.clamp(0, h - 1), j.clamp(0, wd - 1)]
            xn, _ = _prologue(box, a, b)
            win = torch.zeros(window, cin)
            win[1:1 + box.shape[0] * pitch] = torch.where(
                inside[..., None], xn.float(), 0.0).reshape(-1, cin)
            acc = sum(win[shift:shift + computed] @ w[t] for t, shift in
                      enumerate(di * pitch + dj for di in range(3)
                                for dj in range(3)))
            k = torch.arange(computed)
            r, c = k // pitch, k % pitch
            keep = (r < here_r) & (c >= 1) & (c <= here_c)
            y[img, i0 + r[keep], j0 + c[keep] - 1] = acc[keep]
            part[grp, 0] += acc[keep].sum(0)
            part[grp, 1] += (acc[keep] * acc[keep]).sum(0)
    s1, s2 = part[0].clone()
    for grp in range(1, groups):
        s1, s2 = s1 + part[grp, 0], s2 + part[grp, 1]
    return y.to(x.dtype), s1, s2


def conv3_work_split(n, h, w, cin, cout, sms):
    """K8's backward work split: the band plan and the CTAs per channel
    tile of each product, so that each grid fills the SMs once (dw: one
    CTA per (cin, cout) tile and group; dx: per cin tile and group)."""
    rows, cols = conv3_band_plan(h, w, cout)
    bands = n * -(-h // rows) * -(-w // cols)
    dw_tiles = (cin // _C3_TILE) * (cout // _C3_TILE)
    dx_tiles = cin // _C3_TILE
    return dict(rows=rows, cols=cols, bands=bands,
                dw_groups=max(1, min(bands, sms // dw_tiles)),
                dx_groups=max(1, min(bands, sms // dx_tiles)))


def _launch_conv3_fwd(x, w9, a, b):
    n, h, wd, cin = x.shape
    cout = w9.shape[2]
    dev = x.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = conv3_fwd_work_split(n, h, wd, cin, cout, sms)
    y = torch.empty((n, h, wd, cout), device=dev, dtype=torch.bfloat16)
    part = torch.empty((plan["groups"], 2, cout), device=dev,
                       dtype=torch.float32)
    stats = torch.empty((2, cout), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _conv3_library().conv3x3_bn_fwd(
            x.data_ptr(), w9.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), part.data_ptr(), stats.data_ptr(), n, h, wd, cin,
            cout, plan["rows"], plan["cols"], plan["groups"], stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_bn_fwd launch failed: CUDA error {rc}")
    return y, stats[0], stats[1]


def _launch_conv3_bwd(x, w9, a, b, y, gy, gs1, gs2):
    n, h, wd, cin = x.shape
    cout = w9.shape[2]
    dev = x.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = conv3_work_split(n, h, wd, cin, cout, sms)
    f32 = dict(device=dev, dtype=torch.float32)
    dyc = torch.empty((n, h, wd, cout), device=dev, dtype=torch.bfloat16)
    dx = torch.empty((n, h, wd, cin), device=dev, dtype=torch.bfloat16)
    part_dw = torch.empty((plan["dw_groups"], 9, cin, cout), **f32)
    part_dx = torch.empty((plan["dx_groups"], 2, cin), **f32)
    dw = torch.empty((9, cin, cout), **f32)
    dadb = torch.empty((2, cin), **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _conv3_library().conv3x3_bn_bwd(
            x.data_ptr(), w9.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), gy.data_ptr(), gs1.data_ptr(), gs2.data_ptr(),
            dyc.data_ptr(), dx.data_ptr(), part_dw.data_ptr(),
            part_dx.data_ptr(), dw.data_ptr(), dadb.data_ptr(), n, h, wd,
            cin, cout, plan["rows"], plan["cols"], plan["dw_groups"],
            plan["dx_groups"], stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3_bn_bwd launch failed: CUDA error {rc}")
    return dx, dw, dadb[0], dadb[1]


def conv1x1_bn_fwd_cuda(x2d, w, a=None, b=None):
    """Launch K7's forward (CUDA, bfloat16). Same contract as
    :func:`conv1x1_bn_fwd_reference`; raises ``ValueError`` on inputs the
    kernel does not take and ``RuntimeError`` when a launch fails."""
    if x2d.dim() != 2 or w.dim() != 2 or w.shape[0] != x2d.shape[1]:
        raise ValueError(f"want x [rows, cin] and w [cin, cout]; got "
                         f"{tuple(x2d.shape)} and {tuple(w.shape)}")
    rows, cin = x2d.shape
    cout = w.shape[1]
    _check_cuda(dict(x=x2d, w=w, a=a, b=b))
    _check_channels(rows, cin, cout)
    out = _launch_fwd(x2d, w, a, b, rows, cin, cout)
    conv1x1_bn_fwd_cuda.launches += 1
    return out


conv1x1_bn_fwd_cuda.launches = 0


def conv1x1_bn_bwd_cuda(x2d, w, a, b, gy, gs1, gs2):
    """Launch K7's backward (CUDA, bfloat16): the one pass or the dyc, dx
    and split-K dw kernels (``k7_bwd_plan``), and their reductions,
    counted as one launch. Same contract as
    :func:`conv1x1_bn_bwd_reference`."""
    rows, cin = x2d.shape
    cout = w.shape[1]
    if tuple(gy.shape) != (rows, cout) or gs1.shape != (cout,) \
            or gs2.shape != (cout,):
        raise ValueError(f"cotangents {tuple(gy.shape)}, "
                         f"{tuple(gs1.shape)}, {tuple(gs2.shape)} do not "
                         f"match y [{rows}, {cout}]")
    _check_cuda(dict(x=x2d, w=w, a=a, b=b, gy=gy, gs1=gs1, gs2=gs2))
    _check_channels(rows, cin, cout)
    out = _launch_bwd(x2d, w, a, b, gy, gs1, gs2, rows, cin, cout)
    conv1x1_bn_bwd_cuda.launches += 1
    return out


conv1x1_bn_bwd_cuda.launches = 0


def _check_3x3(x, w9):
    if x.dim() != 4 or w9.dim() != 3 or w9.shape[0] != 9 \
            or w9.shape[1] != x.shape[3]:
        raise ValueError(f"want x [n, h, w, cin] and w9 [9, cin, cout]; got "
                         f"{tuple(x.shape)} and {tuple(w9.shape)}")


def conv3x3_bn_fwd_cuda(x, w9, a, b):
    """Launch K8's forward (CUDA, bfloat16): the band kernel and the
    reduction of its statistics (``csrc/conv3x3_bn.cu``), counted as one
    launch. Same contract as :func:`conv3x3_bn_fwd_reference`."""
    _check_3x3(x, w9)
    n, h, wd, cin = x.shape
    cout = w9.shape[2]
    _check_cuda(dict(x=x, w=w9, a=a, b=b), prologue_needed=True)
    _check_channels(n * h * wd, cin, cout)
    out = _launch_conv3_fwd(x, w9, a, b)
    conv3x3_bn_fwd_cuda.launches += 1
    return out


conv3x3_bn_fwd_cuda.launches = 0


def conv3x3_bn_bwd_cuda(x, w9, a, b, y, gy, gs1, gs2):
    """Launch K8's backward (CUDA, bfloat16) from the saved ``y``: the
    dyc kernel, the band kernels for dw and dx and their reductions
    (``csrc/conv3x3_bn.cu``), counted as one launch. Same contract as
    :func:`conv3x3_bn_bwd_reference`."""
    _check_3x3(x, w9)
    n, h, wd, cin = x.shape
    cout = w9.shape[2]
    if tuple(y.shape) != (n, h, wd, cout) or y.shape != gy.shape \
            or gs1.shape != (cout,) or gs2.shape != (cout,):
        raise ValueError(f"y {tuple(y.shape)}, gy {tuple(gy.shape)}, gs1 "
                         f"{tuple(gs1.shape)}, gs2 {tuple(gs2.shape)} do "
                         f"not match [{n}, {h}, {wd}, {cout}]")
    _check_cuda(dict(x=x, w=w9, a=a, b=b, y=y, gy=gy, gs1=gs1, gs2=gs2),
                prologue_needed=True)
    _check_channels(n * h * wd, cin, cout)
    out = _launch_conv3_bwd(x, w9, a, b, y, gy, gs1, gs2)
    conv3x3_bn_bwd_cuda.launches += 1
    return out


conv3x3_bn_bwd_cuda.launches = 0


# -- autograd ----------------------------------------------------------------

def _f32(t):
    return None if t is None else t.float().contiguous()


class Conv1x1BNFunction(torch.autograd.Function):
    """K7 with its one-pass backward: ``(x2d, w, a, b) -> (y, s1, s2)``;
    ``a``/``b`` may be None (no prologue). A CUDA tensor runs the
    kernels, a CPU tensor the plain versions. Saves x, w, a, b, as the
    JAX package's VJP does."""

    @staticmethod
    def forward(ctx, x2d, w, a, b):
        ctx.ab_dtypes = _dtypes(a, b)
        x2d, w, a, b = x2d.contiguous(), w.contiguous(), _f32(a), _f32(b)
        fwd = (conv1x1_bn_fwd_cuda if x2d.is_cuda
               else conv1x1_bn_fwd_reference)
        y, s1, s2 = fwd(x2d, w, a, b)
        ctx.save_for_backward(x2d, w, a, b)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x2d, w, a, b = ctx.saved_tensors
        bwd = (conv1x1_bn_bwd_cuda if x2d.is_cuda
               else conv1x1_bn_bwd_reference)
        dx, dw, da, db = bwd(x2d, w, a, b, gy.contiguous(), _f32(gs1),
                             _f32(gs2))
        return (dx, dw.to(w.dtype), *_cast(ctx.ab_dtypes, da, db))


def _dtypes(a, b):
    return (None if a is None else a.dtype, None if b is None else b.dtype)


def _cast(dtypes, da, db):
    """da, db in the dtypes of the a, b given (None stays None)."""
    return tuple(None if g is None else g.to(dt)
                 for g, dt in zip((da, db), dtypes))


class Conv3x3BNFunction(torch.autograd.Function):
    """K8 with its backward: ``(x, w9, a, b) -> (y, s1, s2)``. Saves x,
    w9, a, b and the output y, which the backward reads instead of
    recomputing it, as the JAX package's VJP does."""

    @staticmethod
    def forward(ctx, x, w9, a, b):
        ctx.ab_dtypes = _dtypes(a, b)
        x, w9, a, b = x.contiguous(), w9.contiguous(), _f32(a), _f32(b)
        fwd = (conv3x3_bn_fwd_cuda if x.is_cuda
               else conv3x3_bn_fwd_reference)
        y, s1, s2 = fwd(x, w9, a, b)
        ctx.save_for_backward(x, w9, a, b, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, w9, a, b, y = ctx.saved_tensors
        bwd = (conv3x3_bn_bwd_cuda if x.is_cuda
               else conv3x3_bn_bwd_reference)
        dx, dw, da, db = bwd(x, w9, a, b, y, gy.contiguous(), _f32(gs1),
                             _f32(gs2))
        return (dx, dw.to(w9.dtype), *_cast(ctx.ab_dtypes, da, db))


def fused_conv1x1_bn(x2d, w, a=None, b=None):
    """``y = relu(x*a+b) @ w`` with the BatchNorm-statistic epilogue.
    ``x2d [rows, cin]``, ``w [cin, cout]``, optional f32 ``a, b [cin]``.
    Returns (y [rows, cout] in x's dtype, s1 [cout] f32 = sum(y), s2
    [cout] f32 = sum(y*y)), differentiable."""
    return Conv1x1BNFunction.apply(x2d, w, a, b)


def fused_conv3x3_bn(x, w9, a, b):
    """3x3/s1/p1 conv over ``relu(x*a+b)`` with the statistic epilogue.
    ``x [n, h, w, cin]``, ``w9 [9, cin, cout]`` (tap-major), f32 ``a, b
    [cin]``. Returns (y [n, h, w, cout], s1 [cout], s2 [cout])."""
    return Conv3x3BNFunction.apply(x, w9, a, b)
