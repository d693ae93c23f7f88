"""Kernel modules of the PyTorch port against the JAX package.

On the CPU the port's plain versions (ragged paged attention, RMSNorm)
are held against the JAX package's Pallas kernels in interpret mode and
against its plain versions, on the same numpy-seeded inputs. The
``gpu``-marked tests launch the Hopper kernels and hold them against
the plain versions; they skip on a machine without a CUDA device. This
module imports JAX only inside the ``ref`` fixture, so the card's run
of the ``gpu`` tests needs no JAX.
"""

import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.hopper import paged_attention as hop_pa
from paddle_tpu_torch.ops.hopper import rms_norm as hop_rms
from paddle_tpu_torch.serving import paged_attention as torch_pa


@pytest.fixture(scope="module")
def ref():
    """The JAX package's kernels and plain versions."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from paddle_tpu.ops.pallas.paged_attention import paged_attend_pallas
    from paddle_tpu.ops.pallas.rms_norm import rms_norm_pallas
    from paddle_tpu.serving import paged_attention as jax_pa
    return types.SimpleNamespace(jnp=jnp, pa=jax_pa,
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


@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: c[0])
def test_paged_attend_plain_matches_jax(ref, case, g):
    """The port's plain paged attention equals the JAX Pallas kernel
    (interpret mode) and the JAX plain version."""
    _, bs, max_blocks, s, positions, lengths = case
    kv, d = 2, 8
    x = _paged_inputs(np.random.RandomState(7), bs=bs, max_blocks=max_blocks,
                      s=s, positions=positions, lengths=lengths, kv=kv, g=g,
                      d=d)
    got = torch_pa.paged_attend(
        torch.from_numpy(x["q"]), torch.from_numpy(x["kbuf"]),
        torch.from_numpy(x["vbuf"]), torch.from_numpy(x["tables"]),
        torch.from_numpy(x["positions"]), kv_heads=kv, head_dim=d).numpy()
    args = tuple(ref.jnp.asarray(x[n])
                 for n in ("q", "kbuf", "vbuf", "tables", "positions"))
    want_kernel = np.asarray(ref.paged_attend_pallas(
        *args, kv_heads=kv, head_dim=d, interpret=True))
    want_plain = np.asarray(ref.pa.paged_attend(*args, kv_heads=kv,
                                                head_dim=d))
    assert got.shape == (len(positions), s, kv, g, d)
    np.testing.assert_allclose(got, want_kernel, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want_plain, atol=ATOL, rtol=RTOL)


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


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: c[0])
def test_paged_attend_kernel_matches_plain(cuda, case, g, dtype):
    """Kernel K5 equals the plain version on the same pool: f32
    accumulation on both sides, so 1e-3 covers summation order."""
    _, bs, max_blocks, s, positions, lengths = case
    kv, d = 2, 128
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


@pytest.mark.gpu
def test_paged_attend_kernel_rejects_unsupported_shapes(cuda):
    q = torch.zeros(1, 1, 2, 96, device=cuda)
    kb = torch.zeros(2, 4, 2, 96, device=cuda)
    tab = torch.zeros(1, 1, dtype=torch.int32, device=cuda)
    pos = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        hop_pa.paged_attend_cuda(q, kb, kb, tab, pos, kv_heads=2, head_dim=96)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 128])
def test_rms_norm_kernel_matches_plain(cuda, rows):
    """Kernel K6 equals the plain version: output within 2 bf16 ulps,
    rstd to 1e-5."""
    gen = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn(rows, 4096, device=cuda, generator=gen).bfloat16()
    w = (1 + 0.1 * torch.randn(4096, device=cuda, generator=gen)).bfloat16()
    out, rstd = hop_rms.rms_norm_cuda(x, w, 1e-5)
    want, want_r = hop_rms.rms_norm_reference(x, w, 1e-5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), atol=1.6e-2,
                               rtol=1.6e-2)
    torch.testing.assert_close(rstd, want_r, atol=0, rtol=1e-5)
