"""Kernel modules of the PyTorch port against the JAX package.

On the CPU the port's plain versions (ragged paged attention, RMSNorm
and RMSNorm's gradient) are held against the JAX package's Pallas
kernels in interpret mode and against its plain versions, on the same
numpy-seeded inputs. The
``gpu``-marked tests launch the Hopper kernels and hold them against
the plain versions; they skip on a machine without a CUDA device. This
module imports JAX only inside the ``ref`` fixture, so the card's run
of the ``gpu`` tests needs no JAX.
"""

import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.hopper import bn_stats as hop_bn
from paddle_tpu_torch.ops.hopper import paged_attention as hop_pa
from paddle_tpu_torch.ops.hopper import rms_norm as hop_rms
from paddle_tpu_torch.serving import paged_attention as torch_pa


@pytest.fixture(scope="module")
def ref():
    """The JAX package's kernels and plain versions."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.paged_attention import paged_attend_pallas
    from paddle_tpu.nn import functional as jax_F
    from paddle_tpu.ops.pallas.rms_norm import rms_norm_pallas
    from paddle_tpu.serving import paged_attention as jax_pa
    return types.SimpleNamespace(jax=jax, jnp=jnp, pa=jax_pa, F=jax_F,
                                 paged_attend_pallas=paged_attend_pallas,
                                 rms_norm_pallas=rms_norm_pallas)


# f32 on both sides; only the order of summation differs
ATOL = RTOL = 1e-5

# (name, bs, max_blocks, s, positions, lengths); a length-0 row is an
# idle decode slot reading scratch block 0
PAGED_CASES = [
    ("decode_mixed_depths_idle_row", 4, 6, 1, [0, 5, 13, 0], [1, 1, 1, 0]),
    ("prefill_chunk_mid_context", 4, 6, 8, [6], [8]),
    ("prefill_160_rows", 16, 11, 160, [0], [160]),
    ("block_boundary_and_full_table", 4, 6, 4, [4, 20], [4, 4]),
]


def _paged_inputs(rng, *, bs, max_blocks, s, positions, lengths, kv, g, d,
                  dtype=np.float32):
    """Seeded q/k/v, a pool and block tables: each live row owns
    distinct random blocks covering its context; idle rows point at
    scratch block 0."""
    b = len(positions)
    num_blocks = 1 + b * max_blocks
    q = rng.randn(b, s, kv * g, d).astype(dtype)
    k = rng.randn(b, s, kv, d).astype(dtype)
    v = rng.randn(b, s, kv, d).astype(dtype)
    kbuf = rng.randn(num_blocks, bs, kv, d).astype(dtype)
    vbuf = rng.randn(num_blocks, bs, kv, d).astype(dtype)
    perm = rng.permutation(np.arange(1, num_blocks)).astype(np.int32)
    tables = np.zeros((b, max_blocks), np.int32)
    for i, (p, n) in enumerate(zip(positions, lengths)):
        if n:
            used = -(-(p + s) // bs)
            tables[i, :used] = perm[i * max_blocks:i * max_blocks + used]
    return dict(q=q, k=k, v=v, kbuf=kbuf, vbuf=vbuf, tables=tables,
                positions=np.asarray(positions, np.int32),
                lengths=np.asarray(lengths, np.int32))


_JAX_PAGED = {}


def _jax_paged(ref, case, g, kv=2, d=8):
    """The case's inputs and the JAX side's outputs (the Pallas kernel in
    interpret mode and the plain version, compiled together once per
    case and group size)."""
    name, bs, max_blocks, s, positions, lengths = case
    if (name, g) in _JAX_PAGED:
        return _JAX_PAGED[name, g]
    x = _paged_inputs(np.random.RandomState(7), bs=bs, max_blocks=max_blocks,
                      s=s, positions=positions, lengths=lengths, kv=kv, g=g,
                      d=d)
    args = tuple(ref.jnp.asarray(x[n])
                 for n in ("q", "kbuf", "vbuf", "tables", "positions"))

    def jax_side(*a):
        return (ref.paged_attend_pallas(*a, kv_heads=kv, head_dim=d,
                                        interpret=True),
                ref.pa.paged_attend(*a, kv_heads=kv, head_dim=d))

    want_kernel, want_plain = map(np.asarray, ref.jax.jit(jax_side)(*args))
    _JAX_PAGED[name, g] = x, want_kernel, want_plain
    return _JAX_PAGED[name, g]


def _torch_args(x):
    return tuple(torch.from_numpy(x[n])
                 for n in ("q", "kbuf", "vbuf", "tables", "positions"))


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: c[0])
def test_paged_attend_plain_matches_jax(ref, case, g):
    """The port's plain paged attention equals the JAX Pallas kernel
    (interpret mode) and the JAX plain version."""
    x, want_kernel, want_plain = _jax_paged(ref, case, g)
    got = torch_pa.paged_attend(*_torch_args(x), kv_heads=2,
                                head_dim=8).numpy()
    assert got.shape == (len(case[4]), case[3], 2, g, 8)
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want_plain, atol=ATOL, rtol=RTOL)


def _split_widths(case):
    """One page, and the widest row horizon short of the table width: a
    span boundary that falls exactly on that row's last visible column."""
    _, bs, max_blocks, s, positions, _ = case
    width = bs * max_blocks
    return {"page": bs,
            "horizon": max(p + s for p in positions if p + s < width)}


@pytest.mark.parametrize("split", ["page", "horizon"])
@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: c[0])
def test_paged_attend_split_plan_matches_jax(ref, case, split):
    """K5's algorithm (per-span partial softmaxes merged by log-sum-exp,
    spans fully masked for a row at weight 0) equals the JAX Pallas
    kernel (interpret mode) and the JAX plain version, and the port's
    plain version."""
    x, want_kernel, want_plain = _jax_paged(ref, case, 2)
    args = _torch_args(x)
    got = hop_pa.paged_attend_split_reference(
        *args, kv_heads=2, head_dim=8,
        split_cols=_split_widths(case)[split]).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want_plain, atol=ATOL, rtol=RTOL)
    plain = hop_pa.paged_attend_reference(*args, kv_heads=2,
                                          head_dim=8).numpy()
    np.testing.assert_allclose(got, plain, atol=ATOL, rtol=RTOL)


def test_paged_attend_body_is_fixed_by_dtype_and_shape():
    """f32 never takes the tensor cores; bf16/f16 take them from
    TC_MIN_QUERIES query vectors per tile; the spans the kernel chooses
    among are whole 64-key stages within its limit."""
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for s, g in ((1, 1), (1, 8), (4, 1), (128, 1), (1, 64)):
            assert hop_pa._tensor_cores(dt, s, g) == (
                dt != torch.float32 and s * g >= hop_pa.TC_MIN_QUERIES)
    assert all(c % 64 == 0 and 64 <= c <= 1024 for c in hop_pa.SPAN_CHOICES)


def test_paged_write_kv_matches_jax(ref):
    """Pool writes land exactly where the JAX package puts them. Pad
    rows and idle slots all write scratch block 0, where which write
    lands is undefined, so block 0 is left out of the comparison."""
    bs, max_blocks, s = 4, 4, 6
    x = _paged_inputs(np.random.RandomState(3), bs=bs, max_blocks=max_blocks,
                      s=s, positions=[2, 9, 0], lengths=[6, 3, 0], kv=2, g=1,
                      d=8)
    kb, vb = torch.from_numpy(x["kbuf"].copy()), torch.from_numpy(
        x["vbuf"].copy())
    torch_pa.paged_write_kv(kb, vb, torch.from_numpy(x["k"]),
                            torch.from_numpy(x["v"]),
                            torch.from_numpy(x["tables"]),
                            torch.from_numpy(x["positions"]),
                            torch.from_numpy(x["lengths"]))
    jk, jv = ref.pa.paged_write_kv(*(
        ref.jnp.asarray(x[n]) for n in ("kbuf", "vbuf", "k", "v", "tables",
                                        "positions", "lengths")))
    np.testing.assert_array_equal(kb.numpy()[1:], np.asarray(jk)[1:])
    np.testing.assert_array_equal(vb.numpy()[1:], np.asarray(jv)[1:])
    # the valid rows really moved: row 0's first token sits at block
    # tables[0, 0] offset 2
    np.testing.assert_array_equal(kb.numpy()[x["tables"][0, 0], 2],
                                  x["k"][0, 0])


def test_gather_copy_blocks_matches_jax(ref):
    """Copying one block onto another in every layer's K and V buffer
    gives the JAX package's buffers."""
    rng = np.random.RandomState(4)
    bufs = [rng.randn(5, 4, 2, 8).astype(np.float32) for _ in range(4)]
    tk = [torch.from_numpy(b.copy()) for b in bufs[:2]]
    tv = [torch.from_numpy(b.copy()) for b in bufs[2:]]
    torch_pa.gather_copy_blocks(tk, tv, 3, 1)
    jk, jv = ref.pa.gather_copy_blocks([ref.jnp.asarray(b) for b in bufs[:2]],
                                       [ref.jnp.asarray(b) for b in bufs[2:]],
                                       3, 1)
    for t, j in zip(tk + tv, list(jk) + list(jv)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (8 significant bits)."""
    a = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_plain_matches_pallas(ref, dtype):
    """The port's plain RMSNorm equals the JAX Pallas kernel in
    interpret mode: f32 to 1e-6, bf16 to one bf16 ulp."""
    rng = np.random.RandomState(5)
    x = (rng.randn(16, 128) * 3).astype(np.float32)
    w = (1 + 0.1 * rng.randn(128)).astype(np.float32)
    eps = 1e-5
    tdt = getattr(torch, dtype)
    jnp = ref.jnp
    jdt = getattr(jnp, dtype)
    got, rstd = hop_rms.rms_norm_reference(torch.from_numpy(x).to(tdt),
                                           torch.from_numpy(w).to(tdt), eps)
    want = np.asarray(ref.rms_norm_pallas(jnp.asarray(x, jdt),
                                          jnp.asarray(w, jdt), eps,
                                          True).astype(jnp.float32))
    got = got.float().numpy()
    assert rstd.dtype == torch.float32 and rstd.shape == (16, 1)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want))


def test_rms_norm_functional_on_cpu_uses_plain_version():
    """nn.functional.rms_norm on a CPU tensor runs the plain version
    and launches nothing."""
    from paddle_tpu_torch.nn.functional import rms_norm

    before = hop_rms.rms_norm_cuda.launches
    x = torch.randn(2, 3, 64, generator=torch.Generator().manual_seed(0))
    w = torch.rand(64, generator=torch.Generator().manual_seed(1))
    out = rms_norm(x, w, epsilon=1e-6)
    want, _ = hop_rms.rms_norm_reference(x.reshape(-1, 64), w, 1e-6)
    torch.testing.assert_close(out, want.reshape(2, 3, 64), atol=0, rtol=0)
    assert hop_rms.rms_norm_cuda.launches == before


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


# (wrapper call, what the error names): a CPU tensor, then shapes and
# dtypes the kernels do not take
NORM_WRAPPER_REFUSALS = {
    "rms_cpu_tensor": (lambda: hop_rms.rms_norm_cuda(_bf16(8, 64), _bf16(64),
                                                     1e-5), "CUDA"),
    "rms_x_not_2d": (lambda: hop_rms.rms_norm_cuda(_bf16(2, 8, 64),
                                                   _bf16(64), 1e-5), "want x"),
    "rms_w_width": (lambda: hop_rms.rms_norm_cuda(_bf16(8, 64), _bf16(32),
                                                  1e-5), "want x"),
    "rms_too_wide": (lambda: hop_rms.rms_norm_cuda(
        _bf16(1, hop_rms.MAX_WIDTH + 1), _bf16(hop_rms.MAX_WIDTH + 1), 1e-5),
        "width"),
    "rms_no_width": (lambda: hop_rms.rms_norm_cuda(_bf16(8, 0), _bf16(0),
                                                   1e-5), "width"),
    "rms_two_dtypes": (lambda: hop_rms.rms_norm_cuda(
        _bf16(8, 64), torch.ones(64), 1e-5), "dtype"),
    "rms_int_dtype": (lambda: hop_rms.rms_norm_cuda(
        torch.zeros(8, 64, dtype=torch.int32),
        torch.zeros(64, dtype=torch.int32), 1e-5), "dtype"),
    "bn_cpu_tensor": (lambda: hop_bn.bn_stats_cuda(_bf16(8, 128)), "CUDA"),
    "bn_x_not_2d": (lambda: hop_bn.bn_stats_cuda(_bf16(128)), "want x"),
    "bn_c_not_128": (lambda: hop_bn.bn_stats_cuda(_bf16(8, 100)), "c % 128"),
    "bn_no_rows": (lambda: hop_bn.bn_stats_cuda(_bf16(0, 128)), "rows"),
    "bn_f32": (lambda: hop_bn.bn_stats_cuda(torch.zeros(8, 128)), "dtype"),
}


@pytest.mark.parametrize("case", sorted(NORM_WRAPPER_REFUSALS))
def test_norm_wrappers_refuse_cpu_tensors_and_shapes_they_do_not_take(case):
    """rms_norm_cuda (K6) and bn_stats_cuda (K9) raise ValueError on a CPU
    tensor and on shapes and dtypes their kernels do not take (checked
    before the device, so the CPU shows each), and launch nothing."""
    call, names = NORM_WRAPPER_REFUSALS[case]
    before = hop_rms.rms_norm_cuda.launches, hop_bn.bn_stats_cuda.launches
    with pytest.raises(ValueError, match=names):
        call()
    assert (hop_rms.rms_norm_cuda.launches,
            hop_bn.bn_stats_cuda.launches) == before


@pytest.mark.parametrize("jax_route", ["rms_norm_pallas", "F.rms_norm"])
def test_rms_norm_function_grads_match_jax(ref, jax_route):
    """dx and dw of the port's RMSNormFunction (the plain forward and the
    port of ``_vjp_bwd``, which the card runs too) equal jax.vjp of the
    JAX Pallas kernel (interpret mode, its custom vjp) and of the JAX
    ``F.rms_norm`` (plain XLA, autodiff): f32, only the order of
    summation differs, 1e-5."""
    from paddle_tpu.framework.autograd import no_grad
    from paddle_tpu.framework.tensor import Tensor

    rng = np.random.RandomState(8)
    x = (rng.randn(16, 128) * 3).astype(np.float32)
    w = (1 + 0.1 * rng.randn(128)).astype(np.float32)
    g = rng.randn(16, 128).astype(np.float32)
    eps = 1e-5
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    out = hop_rms.RMSNormFunction.apply(xt, wt, eps)
    out.backward(torch.from_numpy(g))

    def jax_fn(xa, wa):
        if jax_route == "rms_norm_pallas":
            return ref.rms_norm_pallas(xa, wa, eps, True)
        with no_grad():
            return ref.F.rms_norm(Tensor(xa), Tensor(wa), epsilon=eps)._data

    want, vjp = ref.jax.vjp(jax_fn, ref.jnp.asarray(x), ref.jnp.asarray(w))
    dx, dw = vjp(ref.jnp.asarray(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,h", [(1, 8), (5, 130), (64, 48), (3, 1024)],
                         ids=lambda v: str(v))
def test_rms_norm_function_grads_match_f64_autograd(rows, h, dtype):
    """Over widths that are not a power of two and a single row, dx and
    dw of RMSNormFunction equal autograd through RMSNorm in f64: f32 to
    1e-5 (rounding against exact sums over up to 1024 terms); bf16, whose
    gradients are rounded once to bf16, to two bf16 ulps of each value
    plus 1e-6."""
    rng = np.random.RandomState(rows * 7 + h)
    x = (rng.randn(rows, h) * 3).astype(np.float32)
    w = (1 + 0.1 * rng.randn(h)).astype(np.float32)
    g = rng.randn(rows, h).astype(np.float32)
    eps = 1e-5
    tdt = getattr(torch, dtype)
    # the inputs as the port sees them, rounded to its dtype, so both
    # sides differentiate the same function
    xs, ws, gs = (torch.from_numpy(a).to(tdt) for a in (x, w, g))
    xt, wt = xs.clone().requires_grad_(), ws.clone().requires_grad_()
    hop_rms.RMSNormFunction.apply(xt, wt, eps).backward(gs)
    x64, w64 = (t.double().requires_grad_() for t in (xs, ws))
    r = torch.rsqrt((x64 * x64).mean(dim=-1, keepdim=True) + eps)
    (x64 * r * w64).backward(gs.double())
    assert xt.grad.dtype == wt.grad.dtype == tdt
    for got, want in ((xt.grad, x64.grad), (wt.grad, w64.grad)):
        got, want = got.double().numpy(), want.numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        else:
            assert np.all(np.abs(got - want) <= 2 * _bf16_ulp(want) + 1e-6)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# on the card only (their tables are too wide for interpret mode): decode
# rows whose horizon ends one column before, on and after the span
# boundaries at 256 and 512 columns (of every span the kernel chooses
# among), the full table and an idle row; prefill tiles whose horizon does
# the same at 256, so that a second span is fully masked for the tile's
# early rows
SPLIT_EDGE_CASES = [
    ("decode_split_edges", 16, 256, 1, [254, 255, 256, 510, 511, 512, 4095, 0],
     [1, 1, 1, 1, 1, 1, 1, 0]),
    ("prefill_split_edges", 16, 24, 64, [191, 192, 193], [64, 64, 64]),
]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("g", [1, 4, 64])
@pytest.mark.parametrize("case", PAGED_CASES + SPLIT_EDGE_CASES,
                         ids=lambda c: c[0])
def test_paged_attend_kernel_matches_plain(cuda, case, g, dtype, d):
    """Kernel K5 equals the plain version on the same pool: f32
    accumulation on both sides, so 1e-3 covers summation order."""
    _, bs, max_blocks, s, positions, lengths = case
    kv = 2
    x = _paged_inputs(np.random.RandomState(7), bs=bs, max_blocks=max_blocks,
                      s=s, positions=positions, lengths=lengths, kv=kv, g=g,
                      d=d)
    tdt = getattr(torch, dtype)
    q, kb, vb = (torch.from_numpy(x[n]).to(cuda, tdt)
                 for n in ("q", "kbuf", "vbuf"))
    tab = torch.from_numpy(x["tables"]).to(cuda)
    pos = torch.from_numpy(x["positions"]).to(cuda)
    got = hop_pa.paged_attend_cuda(q, kb, vb, tab, pos, kv_heads=kv,
                                   head_dim=d)
    want = hop_pa.paged_attend_reference(q, kb, vb, tab, pos, kv_heads=kv,
                                         head_dim=d)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


def _edge_inputs(cuda, case, dtype, g=4, seed=5):
    _, bs, max_blocks, s, positions, lengths = case
    x = _paged_inputs(np.random.RandomState(seed), bs=bs,
                      max_blocks=max_blocks, s=s, positions=positions,
                      lengths=lengths, kv=2, g=g, d=128)
    q, kb, vb = (torch.from_numpy(x[n]).to(cuda, dtype)
                 for n in ("q", "kbuf", "vbuf"))
    return (q, kb, vb, torch.from_numpy(x["tables"]).to(cuda),
            torch.from_numpy(x["positions"]).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("split_cols", [128, 256, 512])
@pytest.mark.parametrize("tensor_cores", [False, True])
@pytest.mark.parametrize("case", SPLIT_EDGE_CASES, ids=lambda c: c[0])
def test_paged_attend_kernel_matches_plain_at_every_span(cuda, case,
                                                         tensor_cores,
                                                         split_cols):
    """Both bodies at each span the kernel may choose, on rows whose
    horizon falls around span boundaries: equal to the plain version."""
    args = _edge_inputs(cuda, case, torch.bfloat16)
    got = hop_pa._launch(*args, 2, 128, tensor_cores=tensor_cores,
                         split_cols=split_cols)
    want = hop_pa.paged_attend_reference(*args, kv_heads=2, head_dim=128)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SPLIT_EDGE_CASES, ids=lambda c: c[0])
def test_paged_attend_kernel_is_bitwise_repeatable(cuda, case):
    """The merge sums a row's spans in a fixed order: two calls on the
    same inputs give equal bits."""
    args = _edge_inputs(cuda, case, torch.bfloat16)
    first = hop_pa.paged_attend_cuda(*args, kv_heads=2, head_dim=128)
    second = hop_pa.paged_attend_cuda(*args, kv_heads=2, head_dim=128)
    assert torch.equal(first, second)


@pytest.mark.gpu
def test_paged_attend_kernel_rejects_unsupported_shapes(cuda):
    q = torch.zeros(1, 1, 2, 96, device=cuda)
    kb = torch.zeros(2, 4, 2, 96, device=cuda)
    tab = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        hop_pa.paged_attend_cuda(q, kb, kb, tab, pos, kv_heads=2, head_dim=96)


# K6 against its plain version: the output to two ulps of its dtype (one
# rounding each side plus the order of the row's sum), f32 to 1e-5
K6_TOL = {"bfloat16": 1.6e-2, "float16": 2e-3, "float32": 1e-5}


@pytest.mark.gpu
@pytest.mark.parametrize("rows,h,dtype", [
    (8, 4096, "bfloat16"), (128, 4096, "bfloat16"), (8192, 4096, "bfloat16"),
    (128, 4096, "float32"), (128, 4096, "float16"), (128, 2048, "bfloat16"),
    (128, 8192, "bfloat16"), (64, 1000, "float32"), (128, 4100, "bfloat16"),
    (64, 16384, "bfloat16"), (8, 32768, "float32")])
def test_rms_norm_kernel_matches_plain(cuda, rows, h, dtype):
    """Kernel K6 equals the plain version at the main path's shapes, in
    f32 and f16, at widths 2048 and 8192 (registers), 1000 in f32 (a
    masked tail of packs), 4100 (not a multiple of 8) and 16384 and
    32768 (staged in shared memory): the output to two ulps, rstd to
    1e-5; two calls give equal bits."""
    gen = torch.Generator(device=cuda).manual_seed(rows + h)
    tdt = getattr(torch, dtype)
    x = torch.randn(rows, h, device=cuda, generator=gen).to(tdt)
    w = (1 + 0.1 * torch.randn(h, device=cuda, generator=gen)).to(tdt)
    out, rstd = hop_rms.rms_norm_cuda(x, w, 1e-5)
    out2, rstd2 = hop_rms.rms_norm_cuda(x, w, 1e-5)
    want, want_r = hop_rms.rms_norm_reference(x, w, 1e-5)
    torch.cuda.synchronize()
    tol = K6_TOL[dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(rstd, want_r, atol=0, rtol=1e-5)
    assert torch.equal(out, out2) and torch.equal(rstd, rstd2)


@pytest.mark.gpu
def test_rms_norm_on_card_has_gradient_equal_to_plain_autograd(cuda):
    """F.rms_norm on a CUDA tensor (kernel K6 forward) carries autograd
    history, and its dx/dw equal autograd through the plain version on
    the card: within 2 bf16 ulps of the largest value (one rounding on
    each side plus the order of the row sums)."""
    from paddle_tpu_torch.nn.functional import rms_norm

    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 64, 4096, device=cuda, generator=gen).bfloat16()
    w = (1 + 0.1 * torch.randn(4096, device=cuda, generator=gen)).bfloat16()
    g = torch.randn(2, 64, 4096, device=cuda, generator=gen).bfloat16()
    before = hop_rms.rms_norm_cuda.launches
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = rms_norm(xa, wa, epsilon=1e-5)
    assert out.grad_fn is not None
    assert hop_rms.rms_norm_cuda.launches == before + 1
    out.backward(g)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    want, _ = hop_rms.rms_norm_reference(xb.reshape(-1, 4096), wb, 1e-5)
    want.reshape(x.shape).backward(g)
    torch.cuda.synchronize()
    for got, ref_ in ((xa.grad, xb.grad), (wa.grad, wb.grad)):
        tol = 2 * 2.0 ** -8 * float(ref_.float().abs().max())
        torch.testing.assert_close(got.float(), ref_.float(), atol=tol,
                                   rtol=0)
