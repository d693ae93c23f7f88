"""The fused conv+BatchNorm kernels K7 and K8 and the statistics kernel K9
of the PyTorch port against the JAX package.

On the CPU the port runs its plain versions; the JAX package runs its
Pallas kernels in interpret mode (``paddle_tpu/ops/pallas/resnet_unit.py``
and ``bn_stats.py``). Both take the same numpy inputs in f32, where every
rounding cast is exact, so what is compared is the algorithm: y, s1, s2
(mean, E[x^2]) and every gradient (dx, dw, da, db), with the statistics'
cotangents gs1/gs2 folded in. The JAX side of each case is one
``jax.jit``. ``gpu``-marked cases hold each kernel against its plain
version on the card in bf16; this module imports JAX only inside the
``ref`` fixture, so those cases need no JAX.

Tolerance (f32 cases): the largest absolute difference of each output
is at most 1e-4 of the largest element of the JAX package's output. Both
sides sum the same f32 products in other orders (over up to 576 terms
per element and 256 rows per statistic), which moves the last bits only.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.hopper import bn_stats as hop_bn
from paddle_tpu_torch.ops.hopper import resnet_unit as hop_ru
from torch_threads import one_torch_thread  # noqa: F401

F32_REL = 1e-4


@pytest.fixture(scope="module")
def ref():
    """The JAX package's kernels, one jitted forward + VJP per case."""
    jax = pytest.importorskip("jax")
    from paddle_tpu.ops.pallas import bn_stats as jbn
    from paddle_tpu.ops.pallas import resnet_unit as jru

    def k7(x, w, a, b, cy, c1, c2):
        args = (x, w) if a is None else (x, w, a, b)
        out, vjp = jax.vjp(
            lambda *v: jru.fused_conv1x1_bn(*v, interpret=True), *args)
        return out, vjp((cy, c1, c2))

    def k8(x, w9, a, b, cy, c1, c2):
        out, vjp = jax.vjp(
            lambda *v: jru.fused_conv3x3_bn(*v, interpret=True), x, w9, a, b)
        return out, vjp((cy, c1, c2))

    def k9(x, g1, g2):
        out, vjp = jax.vjp(jbn.bn_stats, x)
        return out, vjp((g1, g2))

    return dict(k7=jax.jit(k7), k8=jax.jit(k8), k9=jax.jit(k9), jru=jru,
                jbn=jbn)


def _close(got, want, name, rel=F32_REL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max())
    tol = rel * float(np.abs(want).max())
    assert err <= tol, f"{name}: max abs err {err} > {tol}"


def _inputs(rng, xs, cin, cout, prologue, w_shape):
    x = rng.randn(*xs, cin).astype(np.float32)
    w = (rng.randn(*w_shape) / np.sqrt(w_shape[-2] * 9)).astype(np.float32)
    a = (rng.rand(cin) + 0.5).astype(np.float32) if prologue else None
    # a shift of either sign, large enough that relu(0 * a + b) != 0: a
    # halo padded before the prologue would show
    b = (rng.randn(cin) * 0.5).astype(np.float32) if prologue else None
    cy = rng.randn(*xs, cout).astype(np.float32)
    c1 = rng.randn(cout).astype(np.float32)
    c2 = (rng.randn(cout) * 0.01).astype(np.float32)
    return x, w, a, b, cy, c1, c2


def _port_grads(fn, x, w, a, b, cy, c1, c2):
    leaves = [torch.from_numpy(v).requires_grad_()
              for v in (x, w, a, b) if v is not None]
    out = fn(*leaves, *([None, None] if a is None else []))
    grads = torch.autograd.grad(out, leaves, [torch.from_numpy(v)
                                              for v in (cy, c1, c2)])
    return out, grads


K7_CASES = {
    # (rows, cin, cout, prologue)
    "rows256_64x128_plain": (256, 64, 128, False),
    "rows256_64x128_prologue": (256, 64, 128, True),
    "rows128_128x64_prologue": (128, 128, 64, True),
    "rows256_128x128_plain": (256, 128, 128, False),
}


@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_conv1x1_bn_plain_matches_pallas(ref, case):
    """K7: y, s1, s2, and dx, dw (and da, db with the prologue), the
    cotangents of s1 and s2 folded in."""
    rows, cin, cout, pro = K7_CASES[case]
    x, w, a, b, cy, c1, c2 = _inputs(np.random.RandomState(rows + cin),
                                     (rows,), cin, cout, pro, (cin, cout))
    want_out, want_grads = ref["k7"](x, w, a, b, cy, c1, c2)
    assert hop_ru.supported(rows, cin, cout)
    out, grads = _port_grads(hop_ru.fused_conv1x1_bn, x, w, a, b, cy, c1, c2)
    for name, g, wnt in zip(("y", "s1", "s2"), out, want_out):
        _close(g, wnt, name)
    for name, g, wnt in zip(("dx", "dw", "da", "db"), grads, want_grads):
        _close(g, wnt, name)


K8_CASES = {
    # (n, h, w, cin, cout)
    "n2_8x8_64": (2, 8, 8, 64, 64),
    "n1_8x16_64x128": (1, 8, 16, 64, 128),
    "n2_6x5_128x64": (2, 6, 5, 128, 64),
}


@pytest.mark.parametrize("case", sorted(K8_CASES))
def test_conv3x3_bn_plain_matches_pallas(ref, case):
    """K8: y, s1, s2, dx, dw, da, db, with a shift b whose relu is not
    zero, so that the halo is checked to be zero after the prologue."""
    n, h, wd, cin, cout = K8_CASES[case]
    x, w9, a, b, cy, c1, c2 = _inputs(np.random.RandomState(n * h * wd),
                                      (n, h, wd), cin, cout, True,
                                      (9, cin, cout))
    assert (np.maximum(b, 0) > 0.1).any()
    want_out, want_grads = ref["k8"](x, w9, a, b, cy, c1, c2)
    out, grads = _port_grads(hop_ru.fused_conv3x3_bn, x, w9, a, b, cy, c1,
                             c2)
    for name, g, wnt in zip(("y", "s1", "s2"), out, want_out):
        _close(g, wnt, name)
    for name, g, wnt in zip(("dx", "dw", "da", "db"), grads, want_grads):
        _close(g, wnt, name)


@pytest.mark.parametrize("rows,c", [(256, 128), (1024, 256)])
def test_bn_stats_plain_matches_pallas(ref, rows, c):
    """K9: mean, E[x^2] and the closed-form gradient (a non-centred
    input, so E[x^2] is not just the variance)."""
    rng = np.random.RandomState(rows)
    x = (rng.randn(rows, c) + 1.5).astype(np.float32)
    g1 = rng.randn(c).astype(np.float32)
    g2 = rng.randn(c).astype(np.float32)
    want_out, (want_dx,) = ref["k9"](x, g1, g2)
    xt = torch.from_numpy(x).requires_grad_()
    out = hop_bn.bn_stats(xt)
    (dx,) = torch.autograd.grad(out, [xt], [torch.from_numpy(g1),
                                            torch.from_numpy(g2)])
    for name, g, wnt in zip(("mean", "m2"), out, want_out):
        _close(g, wnt, name)
    _close(dx, want_dx, "dx")


# K9's shapes: the main path's four (the downsample BatchNorms of layers
# 1-4 at batch 256, 224^2), ragged rows, 8 rows, 128-channel strips
K9_SHAPES = [(802816, 256), (200704, 512), (50176, 1024), (12544, 2048),
             (1000, 256), (8, 256), (12544, 128)]


@pytest.mark.parametrize("shape", K9_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bn_stats_plan_covers_every_row_once(shape):
    """K9's launch at 132 SMs: 256- or 128-channel strips that tile c, a
    CTA's slots covering a strip row (8 channels a thread), at most
    CTAS_PER_SM CTAs an SM, contiguous row ranges of whole row groups
    (the last cut at rows, never empty); and the partial kernel's loop
    (slot j takes rows r0 + j + slots * (UNROLL * k + u), masked at the
    range's end) visits every row of every range exactly once."""
    rows, c = shape
    plan = hop_bn.bn_stats_plan(rows, c, 132)
    strip, slots, rpp = plan["strip"], plan["slots"], plan["rows_per_part"]
    assert strip == (256 if c % 256 == 0 else 128)
    assert strip * plan["strips"] == c
    assert slots * strip // 8 == hop_bn.THREADS
    assert plan["group"] == slots * hop_bn.UNROLL and rpp % plan["group"] == 0
    assert plan["ctas"] == plan["parts"] * plan["strips"]
    assert plan["ctas"] <= 132 * hop_bn.CTAS_PER_SM
    assert (plan["parts"] - 1) * rpp < rows <= plan["parts"] * rpp
    seen = np.zeros(rows, np.int64)
    for p in range(plan["parts"]):
        r0, r1 = p * rpp, min(rows, (p + 1) * rpp)
        for slot in range(slots):
            steps = np.arange(r0 + slot, r1, slots * hop_bn.UNROLL)
            for u in range(hop_bn.UNROLL):
                rr = steps + u * slots
                np.add.at(seen, rr[rr < r1], 1)
    assert (seen == 1).all()


K9_TILE_CASES = {
    # (rows, c, sms, against the Pallas kernel too): 4 partials of
    # 128- and of 256-channel strips at the shapes whose Pallas calls
    # test_bn_stats_plain_matches_pallas compiles; a ragged last range
    # (40 rows of a 32-row group's multiple) over 11 partials; three
    # 128-channel strips with a ragged last range of 72 rows
    "r256_c128_sms1": (256, 128, 1, True),
    "r1024_c256_sms1": (1024, 256, 1, True),
    "r1000_c256_sms3": (1000, 256, 3, False),
    "r200_c384_sms2": (200, 384, 2, False),
}


@pytest.mark.parametrize("case", sorted(K9_TILE_CASES))
def test_bn_stats_tiles_model_matches_plain_and_pallas(ref, case):
    """The plain model of K9's summation order (per slot over its rows,
    slots in order into a partial per CTA, partials by warp, warps in
    order) equals the plain statistics in f32 and, at the shapes the
    Pallas kernel is already compiled for, its interpret-mode mean and
    E[x^2]; more than one partial each, a non-centred input."""
    rows, c, sms, pallas = K9_TILE_CASES[case]
    rng = np.random.RandomState(rows)
    x = (rng.randn(rows, c) + 1.5).astype(np.float32)
    plan = hop_bn.bn_stats_plan(rows, c, sms)
    assert plan["parts"] > 1
    got = hop_bn.bn_stats_tiles_reference(torch.from_numpy(x), plan)
    want = hop_bn.bn_stats_reference(torch.from_numpy(x))
    for name, g, wnt in zip(("mean", "m2"), got, want):
        _close(g, wnt.numpy(), name)
    if pallas:
        zero = np.zeros(c, np.float32)
        want_out, _ = ref["k9"](x, zero, zero)
        for name, g, wnt in zip(("mean", "m2"), got, want_out):
            _close(g, wnt, name)


SHAPES_3X3 = [(256, 56, 56, 64, 64), (256, 28, 28, 128, 128),
              (256, 14, 14, 256, 256), (256, 7, 7, 512, 512),
              (2, 16, 16, 64, 64), (2, 8, 8, 128, 128), (8, 4, 4, 64, 64)]


@pytest.mark.parametrize("shape", SHAPES_3X3)
def test_routing_predicates_equal_the_jax_package(ref, shape):
    """``supported`` and ``supported_3x3`` are copies: the same shapes
    take the same route in both packages."""
    n, h, w, cin, cout = shape
    jru = ref["jru"]
    assert hop_ru.supported_3x3(*shape) == jru.supported_3x3(*shape)
    for rows in (n * h * w, n * h * w // 4, 96):
        assert hop_ru.supported(rows, cin, cout) == jru.supported(rows, cin,
                                                                  cout)
        assert hop_bn.supported(rows, cout) == ref["jbn"].supported(rows,
                                                                    cout)


# K7's backward at ResNet-50's shapes (batch 256, 224^2): (rows, cin, cout,
# prologue) of every 1x1 unit, and a few shapes off the main path
K7_BWD_SHAPES = [
    (802816, 64, 64, False), (802816, 256, 64, False),
    (802816, 64, 256, True), (802816, 256, 128, False),
    (200704, 512, 128, False), (200704, 128, 512, True),
    (200704, 512, 256, False), (50176, 1024, 256, False),
    (50176, 256, 1024, True), (50176, 1024, 512, False),
    (12544, 2048, 512, False), (12544, 512, 2048, True),
    (1000, 64, 256, True), (1000, 256, 64, False), (1000, 128, 128, True),
    (100, 64, 128, False), (81, 192, 64, False), (200, 128, 64, True),
]


@pytest.mark.parametrize("shape", K7_BWD_SHAPES)
def test_dw_splits_cover_the_rows(shape):
    """K7's backward covers every row exactly once: the one pass's CTAs
    own contiguous, non-empty ranges of 128-row tiles that cover the
    tiles in order; the three passes' dw splits are whole 64-row chunks,
    the last one ending at or past the last row, none empty."""
    rows, cin, cout, pro = shape
    plan = hop_ru.k7_bwd_plan(rows, cin, cout, pro, sms=132)
    if plan["design"] == "one_pass":
        ranges = plan["tile_ranges"]
        assert len(ranges) == plan["ctas"] <= 132
        assert ranges[0][0] == 0 and ranges[-1][1] == -(-rows // 128)
        assert all(t0 < t1 for t0, t1 in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert plan["dw_parts"] == plan["ctas"] * (2 if cin == cout == 64
                                                   else 1)
    else:
        splits, ksplit = plan["splits"], plan["ksplit"]
        assert ksplit % 64 == 0 and splits * ksplit >= rows
        assert (splits - 1) * ksplit < rows
        bm, bn = plan["dw_tile"]
        assert cin % bm == 0 and cout % bn == 0
        assert plan["bn_dyc"] in (64, 128) and cout % plan["bn_dyc"] == 0
        assert plan["bn_dx"] in (64, 128) and cin % plan["bn_dx"] == 0


@pytest.mark.parametrize("shape", K7_BWD_SHAPES)
def test_k7_bwd_plan_fits_shared_memory(shape):
    """Every kernel of K7's backward fits an H100 block's 227 KB of
    shared memory (dynamic, from a 1024-byte boundary, and static)."""
    rows, cin, cout, pro = shape
    plan = hop_ru.k7_bwd_plan(rows, cin, cout, pro, sms=132)
    assert plan["smem"] and max(plan["smem"].values()) <= 232448


def test_k7_bwd_plan_picks_the_one_pass_where_it_fits():
    """The one pass exactly where one channel count is 64 and the other
    64, 128 or 256 (w fits 32 KB, each warpgroup owns half of dw), with
    a prologue only at cin = 64: ResNet-50's layer-1 shapes take it, no
    other of its 1x1 units does."""
    widths = (64, 128, 192, 256, 512, 1024, 2048)
    for cin in widths:
        for cout in widths:
            for pro in (False, True):
                want = (min(cin, cout) == 64
                        and max(cin, cout) in (64, 128, 256)
                        and (not pro or cin == 64))
                plan = hop_ru.k7_bwd_plan(4096, cin, cout, pro, sms=132)
                assert (plan["design"] == "one_pass") == want, (cin, cout,
                                                                pro)
    assert all(hop_ru.k7_onepass_takes(*s[1:]) for s in K7_BWD_SHAPES[:3])
    assert not any(hop_ru.k7_onepass_takes(*s[1:])
                   for s in K7_BWD_SHAPES[3:12])


K7_ONEPASS_CASES = {
    # (rows, cin, cout, prologue, ctas): ragged last tiles, CTAs owning
    # one and several tiles, every dw split of the kernel
    "r1000_64x256_prologue_c3": (1000, 64, 256, True, 3),
    "r300_64x64_prologue_c2": (300, 64, 64, True, 2),
    "r700_256x64_c4": (700, 256, 64, False, 4),
    "r260_128x64_c3": (260, 128, 64, False, 3),
    "r200_64x128_c2": (200, 64, 128, False, 2),
}


@pytest.mark.parametrize("case", sorted(K7_ONEPASS_CASES))
def test_conv1x1_bn_bwd_onepass_model_matches_plain(case):
    """The plain model of the one pass's schedule (per-tile dyc rounded
    chunk by chunk, per-CTA and per-warpgroup dw partials, da/db per
    CTA, the fixed-order sums) equals the plain backward in f32."""
    rows, cin, cout, pro, ctas = K7_ONEPASS_CASES[case]
    x, w, a, b, cy, c1, c2 = map(
        lambda v: None if v is None else torch.from_numpy(v),
        _inputs(np.random.RandomState(rows + cout), (rows,), cin, cout, pro,
                (cin, cout)))
    got = hop_ru.conv1x1_bn_bwd_onepass_reference(x, w, a, b, cy, c1, c2,
                                                  ctas=ctas)
    want = hop_ru.conv1x1_bn_bwd_reference(x, w, a, b, cy, c1, c2)
    for name, g, wnt in zip(("dx", "dw", "da", "db"), got, want):
        if wnt is None:
            assert g is None
        else:
            _close(g, wnt.numpy(), name)


@pytest.mark.parametrize("shape", K7_BWD_SHAPES)
def test_k7_fwd_plan_fits_shared_memory(shape):
    """K7's forward kernel fits an H100 block's 227 KB of shared memory
    (dynamic, from a 1024-byte boundary, and static) at every shape."""
    rows, cin, cout, pro = shape
    plan = hop_ru.k7_fwd_plan(rows, cin, cout, pro, sms=132)
    assert plan["smem"] <= 232448


@pytest.mark.parametrize("shape", K7_BWD_SHAPES)
def test_k7_fwd_grid_covers_every_tile_once(shape):
    """The forward's persistent grid: at most one CTA per SM, a multiple
    of the column tiles (or every tile), so that CTA k stays in column
    tile k % nt; CTA k's tiles k, k + ctas, ... cover every (row tile,
    column tile) once, and the CTAs of partial p = k // nt own the row
    tiles p, p + parts, ... that the tiles model sums."""
    rows, cin, cout, pro = shape
    plan = hop_ru.k7_fwd_plan(rows, cin, cout, pro, sms=132)
    tiles, nt, ctas = -(-rows // 128), plan["nt"], plan["ctas"]
    assert nt * plan["bn"] == cout and plan["bn"] in (64, 128)
    assert 1 <= ctas <= 132 and ctas % nt == 0
    assert plan["parts"] == ctas // nt
    seen = {}
    for k in range(ctas):
        mine = range(k, nt * tiles, ctas)
        assert {t % nt for t in mine} <= {k % nt}
        assert [t // nt for t in mine] == list(
            range(k // nt, tiles, plan["parts"]))
        for t in mine:
            seen[t] = seen.get(t, 0) + 1
    assert sorted(seen) == list(range(nt * tiles))
    assert set(seen.values()) == {1}


K7_FWD_TILE_CASES = {
    # (rows, cin, cout, prologue, sms): ragged last tiles (the prologue
    # makes their padding rows relu(b) w, which s1/s2 must leave out);
    # 128-wide tiles over 3 partials of 2 column tiles and over 2 of 4,
    # 64-wide tiles over 5 partials
    "r1000_64x256_prologue_s6": (1000, 64, 256, True, 6),
    "r1000_64x256_s6": (1000, 64, 256, False, 6),
    "r300_128x512_prologue_s8": (300, 128, 512, True, 8),
    "r300_128x512_s8": (300, 128, 512, False, 8),
    "r700_256x64_s5": (700, 256, 64, False, 5),
}


@pytest.mark.parametrize("case", sorted(K7_FWD_TILE_CASES))
def test_conv1x1_bn_fwd_tiles_model_matches_plain(case):
    """The plain model of the forward kernel's schedule (padded tiles,
    s1/s2 per partial over its tiles without the rows past the end, the
    fixed-order sum) equals the plain forward in f32, with a shift b
    whose relu is not zero."""
    rows, cin, cout, pro, sms = K7_FWD_TILE_CASES[case]
    x, w, a, b, _, _, _ = _inputs(np.random.RandomState(rows + cout),
                                  (rows,), cin, cout, pro, (cin, cout))
    x, w = torch.from_numpy(x), torch.from_numpy(w)
    a, b = (None, None) if a is None else map(torch.from_numpy, (a, b))
    assert hop_ru.k7_fwd_plan(rows, cin, cout, pro, sms)["parts"] > 1
    got = hop_ru.conv1x1_bn_fwd_tiles_reference(x, w, a, b, sms=sms)
    want = hop_ru.conv1x1_bn_fwd_reference(x, w, a, b)
    for name, g, wnt in zip(("y", "s1", "s2"), got, want):
        _close(g, wnt.numpy(), name)


def test_conv1x1_bn_fwd_tiles_model_matches_pallas(ref):
    """The forward kernel's schedule against the JAX package's Pallas
    forward (interpret mode): layer 1 unit b's channels with the
    prologue, over 3 partials."""
    x, w, a, b, cy, c1, c2 = _inputs(np.random.RandomState(5), (384,), 64,
                                     256, True, (64, 256))
    want, _ = ref["k7"](x, w, a, b, cy, c1, c2)
    got = hop_ru.conv1x1_bn_fwd_tiles_reference(
        *map(torch.from_numpy, (x, w, a, b)), sms=6)
    for name, g, wnt in zip(("y", "s1", "s2"), got, want):
        _close(g, wnt, name)


def _window_pos(h, w, band, pitch, slot):
    """The image position whose window ``slot`` of ``band`` holds (dyc
    for the backward, xn for the forward), or None where it is zero, as
    conv3x3_bn.cu fills it: slot v holds band position v - 1 = rr pitch
    + cc, image (i0 - 1 + rr, j0 - 1 + cc), up to one halo row and column
    past the band; the forward's prologue leaves the slots outside the
    image zero."""
    img, i0, rows, j0, cols = band
    if slot < 1:
        return None
    rr, cc = divmod(slot - 1, pitch)
    i, j = i0 - 1 + rr, j0 - 1 + cc
    if rr > rows + 1 or cc > cols + 1 or not (0 <= i < h and 0 <= j < w):
        return None
    return img, i, j


def _output_pos(band, pitch, k):
    """The image position of output slot ``k`` (band row k // pitch,
    column k % pitch - 1), or None on a pad column or past the band, as
    the kernels' ``interior_pos``."""
    img, i0, rows, j0, cols = band
    r, cc = divmod(k, pitch)
    if r >= rows or not 1 <= cc <= cols:
        return None
    return img, i0 + r, j0 + cc - 1


def _check_band_cover(w, plan, sign):
    """Bands of ``plan`` (rows, cols of the plan's at w x w), of rows that
    do not divide the height, and of rows cut into two column pieces all
    cover every position of every image exactly once, and tap t = 3 di +
    dj of every output slot reads the window slot holding the position
    (i + sign (di - 1), j + sign (dj - 1)), or a zero slot outside the
    image: the forward's taps for sign = 1, the backward's flipped taps
    for sign = -1."""
    n = 2
    for h, rows, cols in ((w, *plan), (w + 3, 5, w), (w, 3, -(-w // 2))):
        pitch, computed, dx_computed, window = hop_ru.conv3_band_geometry(
            rows, cols)
        assert computed <= dx_computed
        bands = list(hop_ru.conv3_bands(n, h, w, rows, cols))
        seen = {}
        for band in bands:
            assert 1 <= band[2] <= rows and 1 <= band[4] <= cols
            for k in range(dx_computed):
                pos = _output_pos(band, pitch, k)
                if pos is None:
                    continue
                seen[pos] = seen.get(pos, 0) + 1
                img, i, j = pos
                for t in range(9):
                    di, dj = divmod(t, 3)
                    if sign > 0:
                        slot = k + di * pitch + dj
                    else:
                        slot = k + (2 - di) * pitch + (2 - dj)
                    assert 0 <= slot < window
                    assert k < computed
                    ii, jj = i + sign * (di - 1), j + sign * (dj - 1)
                    want = ((img, ii, jj) if 0 <= ii < h and 0 <= jj < w
                            else None)
                    assert _window_pos(h, w, band, pitch, slot) == want
        assert sorted(seen) == [(img, i, j) for img in range(n)
                                for i in range(h) for j in range(w)]
        assert set(seen.values()) == {1}
        for groups in (1, 7, len(bands)):
            got = [b for g in range(groups)
                   for b in hop_ru.group_bands(g, groups, len(bands))]
            assert got == list(range(len(bands)))


@pytest.mark.parametrize("w", [56, 28, 14, 9])
def test_conv3_bands_cover_every_position_once(w):
    """K8's backward bands (the plan's at 64 channels, and the ragged
    and two-piece ones): every position once, every flipped tap from the
    window slot holding dyc at (i - di + 1, j - dj + 1), or a zero slot."""
    _check_band_cover(w, hop_ru.conv3_band_plan(w, w, 64), -1)


@pytest.mark.parametrize("w", [56, 28, 14, 9])
def test_conv3_fwd_bands_cover_every_position_once(w):
    """K8's forward bands (the forward plan's, and the ragged and
    two-piece ones): every position once, every tap from the window slot
    holding xn at (i + di - 1, j + dj - 1), or a zero slot outside the
    image."""
    split = hop_ru.conv3_fwd_work_split(2, w, w, 64, 64, sms=132)
    _check_band_cover(w, (split["rows"], split["cols"]), 1)


BAND_PLAN_SHAPES = [(56, 56, 64, 64), (28, 28, 128, 128), (14, 14, 256, 256),
                    (9, 9, 64, 128), (4, 300, 64, 64), (4, 300, 64, 128),
                    (4, 1650, 64, 64), (16, 64, 512, 512)]


@pytest.mark.parametrize("shape", BAND_PLAN_SHAPES)
def test_conv3_band_plan_fits_the_kernels(shape):
    """The plan's bands fit the dx kernel's 256 positions and both
    kernels' shared memory, wide rows split into even column pieces, and
    the work split fills 132 SMs at most once per channel tile."""
    h, w, cin, cout = shape
    rows, cols = hop_ru.conv3_band_plan(h, w, cout)
    _, _, dx_computed, _ = hop_ru.conv3_band_geometry(rows, cols)
    assert 1 <= rows <= h and 1 <= cols <= w and dx_computed <= 256
    assert max(hop_ru.conv3_smem(rows, cols, cout)) <= 232448 - 5120
    assert -(-w // -(-w // cols)) == cols   # even pieces
    split = hop_ru.conv3_work_split(256, h, w, cin, cout, sms=132)
    assert split["bands"] == 256 * -(-h // rows) * -(-w // cols)
    assert split["dw_groups"] * max(1, (cin // 64) * (cout // 64)) <= max(
        132, (cin // 64) * (cout // 64))
    assert 1 <= split["dx_groups"] <= split["bands"]


@pytest.mark.parametrize("shape", BAND_PLAN_SHAPES)
def test_conv3_fwd_band_plan_fits_the_kernel(shape):
    """The forward's bands fit its kernel's 256 positions and its shared
    memory (dx's layout at cin), wide rows split into even column pieces,
    and its grid fills 132 SMs at most once."""
    h, w, cin, cout = shape
    split = hop_ru.conv3_fwd_work_split(256, h, w, cin, cout, sms=132)
    rows, cols = split["rows"], split["cols"]
    _, _, computed, _ = hop_ru.conv3_band_geometry(rows, cols)
    assert 1 <= rows <= h and 1 <= cols <= w and computed <= 256
    assert hop_ru.conv3_smem(rows, cols, cin)[1] <= 232448 - 5120
    assert -(-w // -(-w // cols)) == cols
    assert split["bands"] == 256 * -(-h // rows) * -(-w // cols)
    assert 1 <= split["groups"] <= split["bands"]
    assert split["groups"] * (cout // 64) <= max(132, cout // 64)


FWD_BAND_CASES = {
    # (n, h, w, cin, cout, rows, cols, groups): the plan's band of a whole
    # 14 x 14 image, rows that do not divide the height (a short last
    # band), and three column pieces of a wide image (a short last piece)
    "n2_14x14_plan": (2, 14, 14, 8, 16, None, None, 3),
    "n2_7x9_rows3": (2, 7, 9, 16, 8, 3, 9, 4),
    "n1_4x30_pieces11": (1, 4, 30, 8, 8, 2, 11, 5),
}


@pytest.mark.parametrize("case", sorted(FWD_BAND_CASES))
def test_conv3x3_bn_fwd_bands_match_plain(case):
    """The forward's band algorithm (the prologue only inside the image,
    flat shifts, pad columns and short bands discarded, one statistics
    partial per group) equals the plain forward in f32, with a shift b
    whose relu is not zero: a prologue applied to the zero halo, or a
    discarded position in s1/s2, would show."""
    n, h, wd, cin, cout, rows, cols, groups = FWD_BAND_CASES[case]
    if rows is None:   # the forward's plan at 64 channels
        split = hop_ru.conv3_fwd_work_split(n, h, wd, 64, 64, sms=132)
        rows, cols = split["rows"], split["cols"]
    x, w9, a, b, _, _, _ = _inputs(np.random.RandomState(h * wd + cin),
                                   (n, h, wd), cin, cout, True,
                                   (9, cin, cout))
    assert (np.maximum(b, 0) > 0.1).any()
    x, w9, a, b = map(torch.from_numpy, (x, w9, a, b))
    got = hop_ru.conv3x3_bn_fwd_bands_reference(x, w9, a, b, rows=rows,
                                                cols=cols, groups=groups)
    want = hop_ru.conv3x3_bn_fwd_reference(x, w9, a, b)
    for name, g, wnt in zip(("y", "s1", "s2"), got, want):
        _close(g, wnt.numpy(), name)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The raw CUDA wrappers take only CUDA tensors; the CPU runs the
    plain versions through the Functions instead."""
    x = torch.zeros(128, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        hop_ru.conv1x1_bn_fwd_cuda(x, w)
    with pytest.raises(ValueError, match="CUDA"):
        hop_bn.bn_stats_cuda(torch.zeros(8, 128, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version, bf16
# ---------------------------------------------------------------------------
#
# Tolerances: both sides accumulate in f32 over the same bf16 operands; y,
# dx (bf16 outputs) to 2 bf16 ulps of the largest element (one rounding
# each side, and dyc may round the other way where the two f32 sums
# straddle a bf16 boundary). The f32 sums differ only in summation order
# (over up to 12,544 rows here) and take chip_smoke.py's limits, relative
# to the largest element, about five times what it reads on the H100 at
# ResNet-50's larger shapes: s1, s2, da, db, mean and E[x^2] 2e-5, dw 2e-4.
BF16_REL = 2.0 ** -7
SUM_REL = dict(s1=2e-5, s2=2e-5, da=2e-5, db=2e-5, mean=2e-5, m2=2e-5,
               dw=2e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _card_case(dev, xs, cin, cout, pro, w_shape, seed):
    x, w, a, b, cy, c1, c2 = _inputs(np.random.RandomState(seed), xs, cin,
                                     cout, pro, w_shape)

    def t(v, dt=torch.bfloat16):
        return None if v is None else torch.from_numpy(v).to(dev, dt)
    return (t(x), t(w), t(a, torch.float32), t(b, torch.float32), t(cy),
            t(c1, torch.float32), t(c2, torch.float32))


def _card_close(got, want, name):
    rel = BF16_REL if want.dtype == torch.bfloat16 else SUM_REL[name]
    err = float((got.float() - want.float()).abs().max())
    tol = rel * float(want.float().abs().max())
    assert err <= tol, f"{name}: max abs err {err} > {tol}"


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_conv1x1_bn_kernel_matches_plain(cuda, case):
    rows, cin, cout, pro = K7_CASES[case]
    x, w, a, b, cy, c1, c2 = _card_case(cuda, (rows,), cin, cout, pro,
                                        (cin, cout), 7)
    got = hop_ru.conv1x1_bn_fwd_cuda(x, w, a, b)
    want = hop_ru.conv1x1_bn_fwd_reference(x, w, a, b)
    gotb = hop_ru.conv1x1_bn_bwd_cuda(x, w, a, b, cy, c1, c2)
    wantb = hop_ru.conv1x1_bn_bwd_reference(x, w, a, b, cy, c1, c2)
    torch.cuda.synchronize()
    for name, g, wnt in zip(("y", "s1", "s2", "dx", "dw", "da", "db"),
                            (*got, *gotb), (*want, *wantb)):
        if wnt is not None:
            _card_close(g, wnt, name)


K7_BWD_CARD_CASES = {
    # (rows, cin, cout, prologue): each design of K7's backward at ragged
    # rows (a last 128-row tile of 104), and the three passes' 64-wide
    # tiles (192 -> 320)
    "r1000_64x256_prologue_one_pass": (1000, 64, 256, True),
    "r1000_64x64_one_pass": (1000, 64, 64, False),
    "r1000_256x64_one_pass": (1000, 256, 64, False),
    "r1000_128x512_prologue_three_passes": (1000, 128, 512, True),
    "r1000_192x320_three_passes": (1000, 192, 320, False),
    "r3000_1024x256_three_passes": (3000, 1024, 256, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(K7_BWD_CARD_CASES))
def test_conv1x1_bn_bwd_kernel_matches_plain_and_repeats(cuda, case):
    """K7's backward (the design ``k7_bwd_plan`` picks) against the plain
    version; two calls give equal bits (fixed-order sums, no atomics)."""
    rows, cin, cout, pro = K7_BWD_CARD_CASES[case]
    x, w, a, b, cy, c1, c2 = _card_case(cuda, (rows,), cin, cout, pro,
                                        (cin, cout), 19)
    got = hop_ru.conv1x1_bn_bwd_cuda(x, w, a, b, cy, c1, c2)
    again = hop_ru.conv1x1_bn_bwd_cuda(x, w, a, b, cy, c1, c2)
    want = hop_ru.conv1x1_bn_bwd_reference(x, w, a, b, cy, c1, c2)
    torch.cuda.synchronize()
    for name, g, r, wnt in zip(("dx", "dw", "da", "db"), got, again, want):
        if wnt is None:
            assert g is None
            continue
        assert torch.equal(g, r), f"{name}: two calls differ"
        _card_close(g, wnt, name)


K7_FWD_CARD_CASES = {
    # (rows, cin, cout, prologue): ragged rows (a last 128-row tile of
    # 104) with the prologue, whose padding rows s1/s2 must leave out, at
    # both tile widths
    "r1000_64x256_prologue": (1000, 64, 256, True),
    "r1000_128x512_prologue": (1000, 128, 512, True),
    "r1000_192x320_tiles64": (1000, 192, 320, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(K7_FWD_CARD_CASES))
def test_conv1x1_bn_fwd_kernel_ragged_matches_plain_and_repeats(cuda, case):
    """K7's forward against the plain version at ragged rows; two calls give equal bits (one s1/s2 partial
    per CTA, summed in a fixed order)."""
    rows, cin, cout, pro = K7_FWD_CARD_CASES[case]
    x, w, a, b, _, _, _ = _card_case(cuda, (rows,), cin, cout, pro,
                                     (cin, cout), 23)
    got = hop_ru.conv1x1_bn_fwd_cuda(x, w, a, b)
    again = hop_ru.conv1x1_bn_fwd_cuda(x, w, a, b)
    want = hop_ru.conv1x1_bn_fwd_reference(x, w, a, b)
    torch.cuda.synchronize()
    for name, g, r, wnt in zip(("y", "s1", "s2"), got, again, want):
        assert torch.equal(g, r), f"{name}: two calls differ"
        _card_close(g, wnt, name)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(K8_CASES) + ["n1_9x9_64_ragged"])
def test_conv3x3_bn_kernel_matches_plain(cuda, case):
    n, h, wd, cin, cout = K8_CASES.get(case, (1, 9, 9, 64, 64))
    x, w9, a, b, cy, c1, c2 = _card_case(cuda, (n, h, wd), cin, cout, True,
                                         (9, cin, cout), 11)
    y, s1, s2 = hop_ru.conv3x3_bn_fwd_cuda(x, w9, a, b)
    want = hop_ru.conv3x3_bn_fwd_reference(x, w9, a, b)
    gotb = hop_ru.conv3x3_bn_bwd_cuda(x, w9, a, b, want[0], cy, c1, c2)
    wantb = hop_ru.conv3x3_bn_bwd_reference(x, w9, a, b, want[0], cy, c1, c2)
    torch.cuda.synchronize()
    for name, g, wnt in zip(("y", "s1", "s2", "dx", "dw", "da", "db"),
                            (y, s1, s2, *gotb), (*want, *wantb)):
        _card_close(g, wnt, name)


K8_BWD_CARD_CASES = {
    # (n, h, w, cin, cout): K8's backward bands on ragged and wide images
    # (a 9-row band, two column pieces of 150 or four of 75) and at the
    # main path's three widths
    "n1_9x9_64x128": (1, 9, 9, 64, 128),
    "n1_9x9_128x64": (1, 9, 9, 128, 64),
    "n1_4x300_64": (1, 4, 300, 64, 64),
    "n1_4x300_64x128": (1, 4, 300, 64, 128),
    "n2_56x56_64": (2, 56, 56, 64, 64),
    "n2_28x28_128": (2, 28, 28, 128, 128),
    "n2_14x14_256": (2, 14, 14, 256, 256),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(K8_BWD_CARD_CASES))
def test_conv3x3_bn_bwd_bands_match_plain(cuda, case):
    n, h, wd, cin, cout = K8_BWD_CARD_CASES[case]
    x, w9, a, b, cy, c1, c2 = _card_case(cuda, (n, h, wd), cin, cout, True,
                                         (9, cin, cout), 13)
    y = hop_ru.conv3x3_bn_fwd_reference(x, w9, a, b)[0]
    got = hop_ru.conv3x3_bn_bwd_cuda(x, w9, a, b, y, cy, c1, c2)
    want = hop_ru.conv3x3_bn_bwd_reference(x, w9, a, b, y, cy, c1, c2)
    torch.cuda.synchronize()
    for name, g, wnt in zip(("dx", "dw", "da", "db"), got, want):
        _card_close(g, wnt, name)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(K8_BWD_CARD_CASES))
def test_conv3x3_bn_fwd_bands_match_plain_on_card(cuda, case):
    """K8's forward band kernel on ragged and wide images and at the main
    path's three widths, against the plain version; two calls give
    equal bits (fixed-order sums, no atomics)."""
    n, h, wd, cin, cout = K8_BWD_CARD_CASES[case]
    x, w9, a, b, _, _, _ = _card_case(cuda, (n, h, wd), cin, cout, True,
                                      (9, cin, cout), 17)
    got = hop_ru.conv3x3_bn_fwd_cuda(x, w9, a, b)
    again = hop_ru.conv3x3_bn_fwd_cuda(x, w9, a, b)
    want = hop_ru.conv3x3_bn_fwd_reference(x, w9, a, b)
    torch.cuda.synchronize()
    for name, g, r, wnt in zip(("y", "s1", "s2"), got, again, want):
        assert torch.equal(g, r), f"{name}: two calls differ"
        _card_close(g, wnt, name)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,c,dtype", [
    (256, 128, "bfloat16"), (12544, 2048, "bfloat16"), (1000, 256, "bfloat16"),
    (802816, 256, "bfloat16"), (200704, 512, "bfloat16"),
    (50176, 1024, "bfloat16"), (8, 256, "bfloat16"), (12544, 128, "bfloat16"),
    (50176, 1024, "float16")])
def test_bn_stats_kernel_matches_plain(cuda, rows, c, dtype):
    """K9 equals the plain statistics at the main path's four shapes and
    at ragged rows, 8 rows, 128-channel strips and f16; two calls give
    equal bits (fixed-order sums, no atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(rows + c)
    x = (torch.randn(rows, c, device=cuda, generator=gen) * 2
         + 1.5).to(getattr(torch, dtype))
    got = hop_bn.bn_stats_cuda(x)
    again = hop_bn.bn_stats_cuda(x)
    want = hop_bn.bn_stats_reference(x)
    torch.cuda.synchronize()
    for name, g, a, wnt in zip(("mean", "m2"), got, again, want):
        assert torch.equal(g, a), f"{name}: two calls differ"
        _card_close(g, wnt, name)
