"""Flash attention of the PyTorch port against the JAX package.

On the CPU the port's flash attention runs its plain versions: the
forward (masked softmax in f32) and the FA2 backward from the saved lse,
under the autograd Function the kernels use on the card. They are held
against the JAX package's Pallas kernels in interpret mode
(``flash_attention_pallas`` and ``jax.vjp`` through it, which runs the
backward kernels) on the same numpy-seeded f32 inputs, over the kernel
paths the JAX package takes: the rectangular grid (K1/K2), the folded
triangle (K3/K4), non-causal ``sq != sk``, GQA and the packed head pairs
of ``d=64``. The plain models of the bf16 kernels' schedules (the
forward's key tiles, masks, CTA order and log2-domain softmax; the
backward's tiles, masks, zero padding, rounding and GQA sum order) are
held against the plain forward and backward. The ``gpu``-marked tests
hold the Hopper kernels against
the plain versions; they skip on a machine without a CUDA device. JAX is
imported only inside the ``ref`` fixture.
"""

import math
import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.hopper import flash_attention as hop_fa
from paddle_tpu_torch.ops.hopper.flash_attention import FlashAttentionFunction
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def ref():
    """The JAX package's flash attention: the Pallas entry point, its
    forward dispatch (for the lse) and the plain composition."""
    pytest.importorskip("jax")
    import importlib

    import jax
    import jax.numpy as jnp

    # the package re-exports a function under the module's name
    jax_fa = importlib.import_module(
        "paddle_tpu.nn.functional.flash_attention")
    pallas_fa = importlib.import_module(
        "paddle_tpu.ops.pallas.flash_attention")
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, pallas=pallas_fa,
        reference_attention=jax_fa._reference_attention)


# f32 on both sides; only the order of summation differs (the Pallas
# kernels sum over key blocks of 128, the plain version in one einsum)
ATOL = 2e-5
RTOL = 1e-5

# (name, sq, sk, heads, kv_heads, head_dim, causal): each selects one
# path of the JAX package's flash_attention_pallas
FLASH_CASES = [
    ("causal_s128_rect_K1_K2", 128, 128, 1, 1, 32, True),
    ("causal_s256_triangle_K3_K4", 256, 256, 1, 1, 32, True),
    ("noncausal_sq128_sk256", 128, 256, 1, 1, 32, False),
    ("gqa_g2_causal_s128", 128, 128, 2, 1, 32, True),
    ("d64_g1_packed_pairs", 128, 128, 2, 2, 64, True),
    # the Stable-Diffusion UNet's heads: 8 wide, non-causal
    ("noncausal_s128_d8", 128, 128, 2, 2, 8, False),
]


def _inputs(seed, b, sq, sk, h, kv, d):
    rng = np.random.RandomState(seed)
    return dict(q=rng.randn(b, sq, h, d).astype(np.float32),
                k=rng.randn(b, sk, kv, d).astype(np.float32),
                v=rng.randn(b, sk, kv, d).astype(np.float32),
                dout=rng.randn(b, sq, h, d).astype(np.float32))


def _port_fwd_bwd(x, causal, fn):
    """The port's output and gradients through ``fn(q, k, v)``."""
    q, k, v = (torch.from_numpy(x[n]).requires_grad_() for n in "qkv")
    out = fn(q, k, v)
    out.backward(torch.from_numpy(x["dout"]))
    return [t.detach().numpy() for t in (out, q.grad, k.grad, v.grad)]


def _jax_lse(ref, q, k, v, causal, scale):
    """The lse of the JAX package's forward kernel, in the layout that
    ``flash_attention_pallas`` picks (packed head pairs for d=64 and
    g=1, else heads folded into the batch), as ``[b, h, sq]``."""
    jnp, pallas = ref.jnp, ref.pallas
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if kv == h and d == 64 and h % 2 == 0:
        _, lse = pallas._fwd(q.reshape(b, sq, h * d), k.reshape(b, sk, h * d),
                             v.reshape(b, sk, h * d), h, 1, 2, scale, causal,
                             True)
        return lse[..., 0]
    fold = [jnp.swapaxes(t, 1, 2).reshape(-1, t.shape[1], d)
            for t in (q, k, v)]
    _, lse = pallas._fwd(*fold, 1, h // kv, 1, scale, causal, True)
    return lse.reshape(b, h, sq)


def _f64_attention(x, causal, scale):
    """out, dq, dk, dv and lse ``[b, h, sq]`` of the same inputs in f64
    numpy: softmax attention (query head i reads key/value head i // g)
    and its gradient from ``dout``; causal cases have sq == sk."""
    q, k, v, do = (x[n].astype(np.float64) for n in ("q", "k", "v", "dout"))
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    kh, vh = (np.repeat(t, h // kv, axis=2) for t in (k, v))
    s = np.einsum("bqhd,bkhd->bhqk", q, kh) * scale
    if causal:
        assert sq == sk
        s = np.where(np.tril(np.ones((sq, sk), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    l = p.sum(-1, keepdims=True)
    p /= l
    dp = np.einsum("bqhd,bkhd->bhqk", do, vh)
    ds = p * (dp - (dp * p).sum(-1, keepdims=True))

    def per_kv(t):   # [b, sk, h, d] summed over each key/value head's group
        return t.reshape(b, sk, kv, h // kv, d).sum(3)
    return dict(out=np.einsum("bhqk,bkhd->bqhd", p, vh),
                dq=np.einsum("bhqk,bkhd->bqhd", ds, kh) * scale,
                dk=per_kv(np.einsum("bhqk,bqhd->bkhd", ds, q) * scale),
                dv=per_kv(np.einsum("bhqk,bqhd->bkhd", p, do)),
                lse=(m + np.log(l))[..., 0])


def _assert_close_or_name_the_side(got, want, name, x, causal, scale):
    """``assert_allclose(got, want)`` at ATOL/RTOL; where it fails, the
    message also gives each side's largest error against the f64
    reference of the same inputs, so that a failing run names the side
    that moved."""
    try:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    except AssertionError as e:
        exact = _f64_attention(x, causal, scale)[name]
        raise AssertionError(
            f"{e}\n{name} against an f64 reference of the same inputs: "
            f"port max abs err {float(np.abs(got - exact).max())}, JAX "
            f"{float(np.abs(np.asarray(want, np.float64) - exact).max())}"
        ) from None


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: c[0])
def test_flash_plain_matches_pallas(ref, case):
    """out, lse, dq, dk and dv of the port's plain flash attention equal
    the JAX Pallas kernels (interpret mode) and their vjp. The JAX side
    runs under one ``jax.jit``: the same kernels, compiled once."""
    _, sq, sk, h, kv, d, causal = case
    x = _inputs(3, 1, sq, sk, h, kv, d)
    scale = 1.0 / math.sqrt(d)
    got = _port_fwd_bwd(x, causal, lambda q, k, v:
                        FlashAttentionFunction.apply(q, k, v, causal, scale))
    jnp = ref.jnp

    def jax_side(q, k, v, dout):
        out, vjp = ref.jax.vjp(
            lambda q, k, v: ref.pallas.flash_attention_pallas(
                q, k, v, causal=causal, interpret=True), q, k, v)
        return (out, *vjp(dout), _jax_lse(ref, q, k, v, causal, scale))

    *want, want_lse = ref.jax.jit(jax_side)(
        *(jnp.asarray(x[n]) for n in ("q", "k", "v", "dout")))
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        _assert_close_or_name_the_side(g, np.asarray(w), name, x, causal,
                                       scale)
    _, lse = hop_fa.flash_attention_fwd_reference(
        *(torch.from_numpy(x[n]) for n in "qkv"), causal, scale)
    _assert_close_or_name_the_side(lse.numpy(), np.asarray(want_lse), "lse",
                                   x, causal, scale)


# (name, sq, sk, heads, kv_heads, head_dim, causal, dtype): head_dim 256,
# the widest the Pallas path takes, and 160 (the card pads it to 256), in
# f32; and fp16 (amp's float16) at the rectangular and triangle paths
WIDE_FP16_CASES = [
    ("noncausal_s128_d256_f32", 128, 128, 2, 1, 256, False, "float32"),
    ("causal_s128_d160_f32", 128, 128, 2, 2, 160, True, "float32"),
    ("causal_s128_rect_d64_fp16", 128, 128, 2, 2, 64, True, "float16"),
    ("causal_s256_triangle_d32_fp16", 256, 256, 2, 1, 32, True, "float16"),
]
# fp16 on both sides: each rounds out, dq, dk and dv to fp16, and the
# Pallas kernels round P and dS to fp16 before their products where the
# plain versions keep them f32: 2^-8 (4 fp16 ulps) of the largest value
FP16_REL = 2.0 ** -8


@pytest.mark.parametrize("case", WIDE_FP16_CASES, ids=lambda c: c[0])
def test_flash_plain_matches_pallas_wide_heads_and_fp16(ref, case):
    """The plain versions the port runs on the CPU at head_dim 160 and
    256 (f32, ATOL/RTOL, with lse) and in fp16 equal the JAX Pallas
    kernels (interpret mode) and their vjp on the same inputs."""
    _, sq, sk, h, kv, d, causal, dtype = case
    x = _inputs(7, 1, sq, sk, h, kv, d)
    x = {n: a.astype(np.float16 if dtype == "float16" else np.float32)
         for n, a in x.items()}
    scale = 1.0 / math.sqrt(d)
    got = _port_fwd_bwd(x, causal, lambda q, k, v:
                        FlashAttentionFunction.apply(q, k, v, causal, scale))
    jnp = ref.jnp

    def jax_side(q, k, v, dout):
        out, vjp = ref.jax.vjp(
            lambda q, k, v: ref.pallas.flash_attention_pallas(
                q, k, v, causal=causal, interpret=True), q, k, v)
        return (out, *vjp(dout))

    want = ref.jax.jit(jax_side)(
        *(jnp.asarray(x[n]) for n in ("q", "k", "v", "dout")))
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if dtype == "float32":
            _assert_close_or_name_the_side(g, w, name, x, causal, scale)
        else:
            w32 = w.astype(np.float32)
            np.testing.assert_allclose(
                g.astype(np.float32), w32, rtol=0,
                atol=FP16_REL * float(np.abs(w32).max()), err_msg=name)
    if dtype == "float32":
        _, lse = hop_fa.flash_attention_fwd_reference(
            *(torch.from_numpy(x[n]) for n in "qkv"), causal, scale)
        want_lse = _jax_lse(ref, *(jnp.asarray(x[n]) for n in "qkv"),
                            causal, scale)
        _assert_close_or_name_the_side(lse.numpy(), np.asarray(want_lse),
                                       "lse", x, causal, scale)


@pytest.mark.parametrize("with_bias", [False, True])
def test_functional_ragged_s100_matches_jax_reference_route(ref, with_bias):
    """At s=100, which does not tile by 128, the JAX package routes
    attention to its plain composition; the port's ``F.flash_attention``
    (and ``F.scaled_dot_product_attention`` with an additive bias) agree
    with it in output and gradients, with GQA (4 heads over 2)."""
    x = _inputs(5, 2, 100, 100, 4, 2, 16)
    bias = np.where(np.random.RandomState(6).rand(2, 1, 100, 100) < 0.2,
                    np.float32(-1e4), np.float32(0.0)).astype(np.float32)
    if with_bias:
        def fn(q, k, v):
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=torch.from_numpy(bias), is_causal=True)
    else:
        def fn(q, k, v):
            return F.flash_attention(q, k, v, causal=True)[0]
    got = _port_fwd_bwd(x, True, fn)
    jnp = ref.jnp

    def jax_side(q, k, v, dout):
        out, vjp = ref.jax.vjp(
            lambda q, k, v: ref.reference_attention(
                q, k, v, causal=True,
                bias=jnp.asarray(bias) if with_bias else None), q, k, v)
        return (out, *vjp(dout))

    want = ref.jax.jit(jax_side)(
        *(jnp.asarray(x[n]) for n in ("q", "k", "v", "dout")))
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


# (sq, sk, heads, kv_heads, head_dim, causal): lengths that do not tile
# (1 is a decode step), the GQA ratios 1, 2 and 4, and the head_dims the
# kernels take; causal needs sq == sk (F1)
RAGGED_CASES = [
    (sq, sq, h, kv, 16, True) for sq in (1, 7, 65, 130)
    for h, kv in ((2, 2), (4, 1))
] + [
    (sq, sk, h, kv, 16, False) for sq, sk in ((1, 300), (65, 7), (130, 129))
    for h, kv in ((2, 2), (4, 2))
] + [
    (33, 33, 2, 2, 64, True),
    (64, 64, 4, 1, 128, True),
    (1, 77, 4, 1, 128, False),
]


def _attention_f64(q, k, v, causal, scale):
    """Softmax attention in f64 with K/V heads repeated to q's: the
    straightforward composition, independent of the port's code.
    Returns (out, lse ``[b, h, sq]``)."""
    g = q.shape[2] // k.shape[2]
    k, v = (t.repeat_interleave(g, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(),
                          float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", torch.exp(s - lse[..., None]),
                        v), lse


@pytest.mark.parametrize("case", RAGGED_CASES,
                         ids=lambda c: "sq{}_sk{}_h{}_kv{}_d{}_{}".format(
                             *c[:5], "causal" if c[5] else "full"))
def test_flash_function_matches_f64_attention(case):
    """At lengths that do not tile, the plain forward and the FA2
    backward from the saved lse (what the card's kernels are held
    against) equal autograd through f64 softmax attention: out, lse, dq,
    dk and dv to ATOL/RTOL (f32 rounding against exact sums)."""
    sq, sk, h, kv, d, causal = case
    x = _inputs(sq * 31 + sk, 2, sq, sk, h, kv, d)
    scale = 1.0 / math.sqrt(d)
    got = _port_fwd_bwd(x, causal, lambda q, k, v:
                        FlashAttentionFunction.apply(q, k, v, causal, scale))
    q, k, v = (torch.from_numpy(x[n]).double().requires_grad_() for n in "qkv")
    out, lse = _attention_f64(q, k, v, causal, scale)
    out.backward(torch.from_numpy(x["dout"]).double())
    want = [out.detach(), q.grad, k.grad, v.grad]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w.numpy(), atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    _, got_lse = hop_fa.flash_attention_fwd_reference(
        *(torch.from_numpy(x[n]) for n in "qkv"), causal, scale)
    np.testing.assert_allclose(got_lse.numpy(), lse.detach().numpy(),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shapes,match", [
    (((1, 8, 3, 16), (1, 8, 2, 16)), "multiple of kv heads"),
    (((1, 8, 2, 16), (1, 8, 2, 32)), "batch or head_dim"),
    (((2, 8, 2, 16), (1, 8, 2, 16)), "batch or head_dim"),
    (((8, 2, 16), (8, 2, 16)), "want q"),
], ids=["heads_not_multiple", "head_dim_differs", "batch_differs",
        "three_dims"])
def test_flash_plain_rejects_mismatched_shapes(shapes, match):
    """The plain versions check shapes as the kernels' wrappers do, so a
    call the card would refuse fails on the CPU too."""
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError, match=match):
        hop_fa.flash_attention_fwd_reference(q, k, k, False, 1.0)
    with pytest.raises(ValueError, match=match):
        hop_fa.flash_attention_bwd_reference(q, k, k, q, None, q, False, 1.0)


def test_causal_unequal_lengths_raise():
    """F1: causal attention with sq != sk is top-left in the JAX
    package's kernels and bottom-right in its plain composition; the
    port refuses it on every route."""
    q = torch.zeros(1, 4, 2, 8)
    k = torch.zeros(1, 6, 2, 8)
    with pytest.raises(ValueError, match="causal"):
        F.flash_attention(q, k, k, causal=True)
    with pytest.raises(ValueError, match="causal"):
        F.scaled_dot_product_attention(q, k, k, attn_mask=torch.zeros(1, 6),
                                       is_causal=True)
    with pytest.raises(ValueError, match="causal"):
        hop_fa.flash_attention_fwd_reference(q, k, k, True, 1.0)
    out, _ = F.flash_attention(q, k, k, causal=False)
    assert out.shape == q.shape


def test_dropout_takes_plain_composition_with_callers_generator():
    """Attention dropout draws from the caller's torch.Generator: the
    same seed gives the same output, and evaluation (training=False)
    drops nothing."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, 2, 4, generator=g)

    def run(seed, training=True):
        gen = torch.Generator().manual_seed(seed)
        return F.flash_attention(q, q, q, dropout=0.5, causal=True,
                                 training=training, generator=gen)[0]

    torch.testing.assert_close(run(1), run(1), atol=0, rtol=0)
    assert not torch.equal(run(1), run(2))
    torch.testing.assert_close(run(1, training=False),
                               F.flash_attention(q, q, q, causal=True)[0])


# ---------------------------------------------------------------------------
# the bf16 forward kernel's schedule, as its plain model
# ---------------------------------------------------------------------------

def _tiles(*k0s):
    return [(k, False) for k in k0s]


@pytest.mark.parametrize("q0,sq,sk,causal,want", [
    # the training length: the last q tile walks 32 key tiles, the
    # diagonal one first and masked; the first q tile only its diagonal
    (3968, 4096, 4096, True, [(3968, True)] + _tiles(*range(3840, -1, -128))),
    (0, 4096, 4096, True, [(0, True)]),
    # ragged: 200 = 128 + 72, and 100 (no full tile)
    (128, 200, 200, True, [(128, True), (0, False)]),
    (0, 100, 100, True, [(0, True)]),
    # non-causal: only a ragged last key tile is masked
    (0, 200, 1000, False, [(896, True)] + _tiles(*range(768, -1, -128))),
    (128, 256, 1024, False, _tiles(*range(896, -1, -128))),
], ids=["causal_last_tile", "causal_first_tile", "ragged_s200", "s100",
        "full_sk1000", "full_sk1024"])
def test_fwd_tile_plan(q0, sq, sk, causal, want):
    """The key tiles a 128-row q tile visits, last first, and which of
    them take the mask."""
    assert hop_fa.fwd_tile_plan(q0, sq, sk, causal) == want


@pytest.mark.parametrize("b,h,kv,sq,d,group", [
    (2, 32, 32, 4096, 128, 8),    # the training shape: 2 MiB of K/V a head
    (1, 32, 8, 2048, 128, 32),    # GQA: four heads share a K/V head
    (2, 8, 2, 200, 128, 16),
    (3, 5, 5, 4096, 128, 8),      # 15 heads: a short last group
])
def test_fwd_cta_order(b, h, kv, sq, d, group):
    """Every (batch, head) q tile launches once, in groups of
    ``fwd_group`` (batch, head) pairs, the heaviest q tile first within
    a group."""
    assert hop_fa.fwd_group(b, h, kv, sq, d) == group
    order = hop_fa.fwd_cta_order(b, h, kv, sq, sq, d)
    tiles = range(0, sq, hop_fa.FWD_BLOCK_M)
    assert sorted(order) == sorted((bh, q0) for bh in range(b * h)
                                   for q0 in tiles)
    for start in range(0, b * h, group):
        heads = range(start, min(start + group, b * h))
        chunk = order[start * len(tiles):(heads.stop) * len(tiles)]
        assert {bh for bh, _ in chunk} == set(heads)
        q0s = [q0 for _, q0 in chunk]
        assert q0s == sorted(q0s, reverse=True)


# dq, dk and dv row by row: 8 bf16 ulps of each row's largest value (dS
# rounded to bf16 moves a row whose terms cancel by up to two ulps), that
# scale at least ROW_FLOOR of the tensor's largest value: causal dq's
# first row is zero in exact arithmetic (one key, so P = 1 and dS = dP -
# delta = 0) and rounding noise on both sides
GRAD_ROW_REL = 2.0 ** -5
ROW_FLOOR = 2.0 ** -10


def _assert_rows_close(got, want, rel, floor=0.0):
    """Every row (the last dimension) of ``got`` within ``rel`` of that
    row's largest ``|want|``, and that scale at least ``floor`` times the
    tensor's largest. A row of attention's out is a weighted mean of V
    rows: rows that see many keys are far smaller than the first causal
    rows (and dq of the first rows, dk/dv of the last keys, far smaller
    than the rest), and a limit scaled to the whole tensor's largest
    value would pass a fault confined to them."""
    g, w = got.float(), want.float()
    err = (g - w).abs().amax(-1)
    lim = rel * w.abs().amax(-1).clamp(min=floor * float(w.abs().max()))
    bad = err > lim
    assert not bad.any(), (
        f"{int(bad.sum())} rows beyond {rel} of their largest value; worst "
        f"ratio {float((err / lim).max()) * rel}")


# (name, b, sq, sk, heads, kv_heads, head_dim, causal)
SCHEDULE_CASES = [
    ("causal_s256_d128", 1, 256, 256, 2, 2, 128, True),
    ("causal_ragged_s200_gqa", 1, 200, 200, 4, 2, 128, True),
    ("causal_s100_d64", 2, 100, 100, 2, 1, 64, True),
    ("causal_s300_d64_gqa", 1, 300, 300, 4, 1, 64, True),
    ("full_sq200_sk1000_d64", 1, 200, 1000, 2, 2, 64, False),
    ("full_sq256_sk384_gqa_d128", 1, 256, 384, 4, 2, 128, False),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCHEDULE_CASES, ids=lambda c: c[0])
def test_fwd_schedule_model_matches_plain(case, dtype):
    """The plain model of the bf16 forward kernel (its tile plan, masks
    on the edge tiles only, zero-filled padding, log2-domain online
    softmax, P rounded to the input dtype, lse converted back to a
    natural log) equals the plain forward: f32 to ATOL/RTOL (order of
    summation, exp2 against exp); bf16 out to 4 bf16 ulps of the largest
    value and row by row to 4 bf16 ulps of each row's largest value (P
    rounded before P V), lse to 1e-4: the card's limits."""
    _, b, sq, sk, h, kv, d, causal = case
    x = _inputs(sq + sk, b, sq, sk, h, kv, d)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x[n]).to(tdt) for n in "qkv")
    scale = 1.0 / math.sqrt(d)
    out, lse = hop_fa.fwd_schedule_model(q, k, v, causal, scale)
    want, want_lse = hop_fa.flash_attention_fwd_reference(q, k, v, causal,
                                                          scale)
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    if dtype == "float32":
        torch.testing.assert_close(out, want, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(lse, want_lse, atol=ATOL, rtol=RTOL)
    else:
        tol = 2.0 ** -6 * float(want.float().abs().max())
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=0)
        _assert_rows_close(out, want, 2.0 ** -6)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# the bf16 backward kernels' schedule, as its plain model
# ---------------------------------------------------------------------------

def _dq_tiles(*k0s):
    return [(k, False) for k in k0s]


@pytest.mark.parametrize("kernel,start,sq,sk,causal,g,want", [
    # dq, the training length: the last q tile walks 64 key tiles of 64,
    # the two that cross the diagonal first and masked; the first q tile
    # only those two
    ("dq", 3968, 4096, 4096, True, 1,
     [(4032, True), (3968, True)] + _dq_tiles(*range(3904, -1, -64))),
    ("dq", 0, 4096, 4096, True, 1, [(64, True), (0, True)]),
    # ragged: 200 = 128 + 72, and 100 (no full q tile)
    ("dq", 128, 200, 200, True, 1,
     [(192, True), (128, True), (64, False), (0, False)]),
    ("dq", 0, 100, 100, True, 1, [(64, True), (0, True)]),
    # non-causal: only a ragged last key tile is masked
    ("dq", 0, 200, 1000, False, 1,
     [(960, True)] + _dq_tiles(*range(896, -1, -64))),
    ("dq", 128, 256, 1024, False, 1, _dq_tiles(*range(960, -1, -64))),
    # dkv: a causal key tile starts at its diagonal; the q tiles that
    # cross it are masked, each query head of the group in turn
    ("dkv", 0, 256, 256, True, 1,
     [(0, 0, True), (0, 64, True), (0, 128, False), (0, 192, False)]),
    ("dkv", 128, 200, 200, True, 2,
     [(0, 128, True), (0, 192, True), (1, 128, True), (1, 192, True)]),
    ("dkv", 3968, 4096, 4096, True, 1, [(0, 3968, True), (0, 4032, True)]),
    # non-causal: every q tile, none masked (padding needs no mask)
    ("dkv", 896, 200, 1000, False, 1,
     [(0, q0, False) for q0 in (0, 64, 128, 192)]),
], ids=["dq_causal_last_tile", "dq_causal_first_tile", "dq_ragged_s200",
        "dq_s100", "dq_full_sk1000", "dq_full_sk1024", "dkv_causal_first",
        "dkv_ragged_s200_gqa", "dkv_causal_last", "dkv_full_sk1000"])
def test_bwd_tile_plan(kernel, start, sq, sk, causal, g, want):
    """The tiles a dq CTA (key tiles, last first) or a dkv CTA (q tiles
    of each query head of its group) visits, and which take the mask."""
    assert hop_fa.bwd_tile_plan(kernel, start, sq, sk, causal, g) == want


@pytest.mark.parametrize("b,h,kv,sq,d,group", [
    (2, 32, 32, 4096, 128, 8),    # the training shape: 2 MiB of Q/dO a pair
    (1, 32, 8, 2048, 128, 4),     # GQA: four query heads a KV head
    (2, 8, 2, 200, 128, 4),       # all pairs fit
])
def test_dkv_group(b, h, kv, sq, d, group):
    """The dkv kernel's CTA groups hold the Q and dO of at most 16 MiB of
    (batch, KV head) pairs."""
    assert hop_fa.dkv_group(b, h, kv, sq, d) == group


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SCHEDULE_CASES, ids=lambda c: c[0])
def test_bwd_schedule_model_matches_plain(case, dtype):
    """The plain model of the bf16 backward kernels (their tile plans,
    masks on the plan's tiles only, zero-filled padding with lse = +inf
    past sq, log2-domain exp, P and dS rounded to the input dtype, dK/dV
    summed over the GQA group in order) equals the plain FA2 backward on
    the plain forward's out and lse: f32 to ATOL/RTOL (order of
    summation, exp2 against exp); bf16 dq, dk and dv to 4 bf16 ulps of
    the largest value and row by row to GRAD_ROW_REL: the card's
    limits."""
    _, b, sq, sk, h, kv, d, causal = case
    x = _inputs(sq + sk, b, sq, sk, h, kv, d)
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x[n]).to(tdt)
                   for n in ("q", "k", "v", "dout"))
    scale = 1.0 / math.sqrt(d)
    out, lse = hop_fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    got = hop_fa.bwd_schedule_model(q, k, v, out, lse, do, causal, scale)
    want = hop_fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal,
                                                scale)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if dtype == "float32":
            torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)
        else:
            tol = 2.0 ** -6 * float(w.float().abs().max())
            torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=0)
            _assert_rows_close(g, w, GRAD_ROW_REL, ROW_FLOOR)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [4, 8, 32, 72, 100])
@pytest.mark.parametrize("causal,sq,sk", [(False, 40, 77), (True, 40, 40)],
                         ids=["noncausal_sk77", "causal"])
def test_padded_head_dim_matches_unpadded(d, causal, sq, sk):
    """The kernels' wrappers run a head_dim other than 64 and 128 zero-
    padded to the narrowest of them that holds it (64 below 64, 128
    between), with the caller's scale 1/sqrt(d), and slice out, dq, dk
    and dv back; on the plain versions that equals the unpadded forward
    and backward at d (f32, 1e-5: zero columns add nothing but the order
    of the sums). GQA 4/2, cross-attention lengths 40 x 77 (the UNet's
    77 text tokens) and causal."""
    assert hop_fa.padded_head_dim(d) == (64 if d < 64 else 128)
    rng = np.random.RandomState(d)
    q, k, v, dout = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                     for shape in ((2, sq, 4, d), (2, sk, 2, d),
                                   (2, sk, 2, d), (2, sq, 4, d)))
    scale = 1.0 / math.sqrt(d)
    out, lse = hop_fa.flash_attention_fwd_padded(q, k, v, causal, scale)
    want_out, want_lse = hop_fa.flash_attention_fwd_reference(
        q, k, v, causal, scale)
    assert out.shape == want_out.shape
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    got = hop_fa.flash_attention_bwd_padded(q, k, v, out, lse, dout, causal,
                                            scale)
    want = hop_fa.flash_attention_bwd_reference(q, k, v, want_out, want_lse,
                                                dout, causal, scale)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


def test_padded_head_dim_rule():
    """64, 128 and 256 run as they are; every other width up to 256 pads
    to the narrowest that holds it; above 256 it raises, as the JAX
    package's Pallas path refuses there."""
    assert [hop_fa.padded_head_dim(d) for d in (1, 8, 63, 64, 65, 72, 100,
                                                127, 128)] == \
        [64, 64, 64, 64, 128, 128, 128, 128, 128]
    assert hop_fa.padded_head_dim(129) == 256
    assert hop_fa.padded_head_dim(136) == 256
    assert hop_fa.padded_head_dim(256) == 256
    with pytest.raises(ValueError, match="up to 256"):
        hop_fa.padded_head_dim(257)


def test_launch_counts_by_form():
    """A launch's form is its input type and the head width the kernel
    runs at; ``count_launch`` adds the kernels of one call (a 256-wide
    dkv call launches a dK and a dV kernel) to the wrapper's total and
    to its form's count, and ``reset_launches`` sets both to 0."""
    from paddle_tpu_torch.ops.hopper._build import count_launch, reset_launches

    q = torch.zeros(1, 2, 3, 256, dtype=torch.float16)
    assert hop_fa._form(q) == "torch.float16/d256"
    assert hop_fa._form(q[..., :64].to(torch.bfloat16)) == \
        "torch.bfloat16/d64"

    def wrapper():
        pass

    wrapper.launches, wrapper.launches_by_form = 0, {}
    count_launch(wrapper, "torch.bfloat16/d64")
    count_launch(wrapper, hop_fa._form(q), kernels=2)
    count_launch(wrapper, "torch.bfloat16/d64")
    assert wrapper.launches == 4
    assert wrapper.launches_by_form == {"torch.bfloat16/d64": 2,
                                        "torch.float16/d256": 2}
    reset_launches(wrapper)
    assert (wrapper.launches, wrapper.launches_by_form) == (0, {})
    for fn in (hop_fa.flash_attention_fwd_cuda, hop_fa.flash_attention_dq_cuda,
               hop_fa.flash_attention_dkv_cuda):
        assert isinstance(fn.launches_by_form, dict)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", FLASH_CASES + [
    ("ragged_s200_gqa_d128", 200, 200, 8, 2, 128, True),
    # the bf16 forward's 128-row tiles: no full tile, one and a half, a
    # ragged non-causal key end, and d=64 with GQA
    ("causal_s100_gqa_d128", 100, 100, 4, 2, 128, True),
    ("causal_s192_d128", 192, 192, 4, 4, 128, True),
    ("noncausal_sq200_sk1000_d128", 200, 1000, 4, 4, 128, False),
    ("causal_s300_gqa_d64", 300, 300, 8, 2, 64, True)], ids=lambda c: c[0])
def test_flash_kernels_match_plain(cuda, case, dtype):
    """The forward, dq and dkv kernels equal the plain versions on the
    same inputs: f32 to 1e-4 (order of summation), bf16 to 4 bf16 ulps
    of the largest value, and out also to 4 ulps of each row's largest
    value, dq, dk and dv to GRAD_ROW_REL (each side rounds its outputs to
    bf16, and the kernels round P and dS to bf16 before their
    products)."""
    _, sq, sk, h, kv, d, causal = case
    if d not in hop_fa.HEAD_DIMS:
        d = 64
    x = _inputs(11, 2, sq, sk, h, kv, d)
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x[n]).to(cuda, tdt)
                   for n in ("q", "k", "v", "dout"))
    scale = 1.0 / math.sqrt(d)
    out, lse = hop_fa.flash_attention_fwd_cuda(q, k, v, causal, scale)
    want_out, want_lse = hop_fa.flash_attention_fwd_reference(q, k, v, causal,
                                                              scale)
    got = (out, *hop_fa.flash_attention_bwd_cuda(q, k, v, want_out, want_lse,
                                                 do, causal, scale))
    want = (want_out, *hop_fa.flash_attention_bwd_reference(
        q, k, v, want_out, want_lse, do, causal, scale))
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    for g, w in zip(got, want):
        w = w.float()
        tol = 1e-4 if dtype == "float32" else 2.0 ** -6 * float(
            w.abs().max())
        torch.testing.assert_close(g.float(), w, atol=tol, rtol=0)
    if dtype != "float32":
        _assert_rows_close(out, want_out, 2.0 ** -6)
        for g, w in zip(got[1:], want[1:]):
            _assert_rows_close(g, w, GRAD_ROW_REL, ROW_FLOOR)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("causal,sq,sk", [(True, 200, 200), (False, 130, 77)],
                         ids=["causal_s200", "noncausal_sq130_sk77"])
def test_flash_kernels_wide_heads_match_plain(cuda, causal, sq, sk, d,
                                              dtype):
    """At head_dim 256 (and 160, zero-padded to 256) the CUDA-core
    kernels take every type: out, lse, dq, dk and dv equal the plain
    versions, f32 to 1e-4, 16-bit to 4 bf16 ulps of the largest value
    (fp16 keeps more bits), GQA 8/2, ragged tiles."""
    x = _inputs(d + sq, 2, sq, sk, 8, 2, d)
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(x[n]).to(cuda, tdt)
                   for n in ("q", "k", "v", "dout"))
    scale = 1.0 / math.sqrt(d)
    out, lse = hop_fa.flash_attention_fwd_cuda(q, k, v, causal, scale)
    want_out, want_lse = hop_fa.flash_attention_fwd_reference(q, k, v, causal,
                                                              scale)
    got = (out, *hop_fa.flash_attention_bwd_cuda(q, k, v, want_out, want_lse,
                                                 do, causal, scale))
    want = (want_out, *hop_fa.flash_attention_bwd_reference(
        q, k, v, want_out, want_lse, do, causal, scale))
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    for g, w in zip(got, want):
        assert g.dtype == tdt and g.shape == w.shape
        w = w.float()
        tol = 1e-4 if dtype == "float32" else 2.0 ** -6 * float(
            w.abs().max())
        torch.testing.assert_close(g.float(), w, atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_flash_fwd_is_deterministic(cuda, d):
    """Two calls of the bf16 forward give the same bits (out and lse):
    every row is summed by one warpgroup in a fixed order."""
    x = _inputs(13, 2, 520, 520, 8, 2, d)
    q, k, v = (torch.from_numpy(x[n]).to(cuda, torch.bfloat16) for n in "qkv")
    first = hop_fa.flash_attention_fwd_cuda(q, k, v, True, d ** -0.5)
    second = hop_fa.flash_attention_fwd_cuda(q, k, v, True, d ** -0.5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_is_deterministic(cuda, d):
    """Two calls of the bf16 dq and dkv kernels give the same bits: no
    atomics, every dq, dk and dv element summed by one warpgroup in a
    fixed order (dk/dv over the GQA group's query heads in turn)."""
    x = _inputs(23, 2, 520, 520, 8, 2, d)
    q, k, v, do = (torch.from_numpy(x[n]).to(cuda, torch.bfloat16)
                   for n in ("q", "k", "v", "dout"))
    out, lse = hop_fa.flash_attention_fwd_cuda(q, k, v, True, d ** -0.5)
    first = hop_fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, True,
                                            d ** -0.5)
    second = hop_fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, True,
                                             d ** -0.5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
def test_flash_fwd_runs_on_every_card(cuda):
    """One process calls the bf16 forward on each card in turn, and each
    call agrees with the plain forward: the kernel's opt-in to more
    shared memory holds per device, so it is made on every call."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    x = _inputs(19, 1, 256, 256, 4, 2, 128)
    for i in range(torch.cuda.device_count()):
        q, k, v = (torch.from_numpy(x[n]).to(torch.device("cuda", i),
                                             torch.bfloat16) for n in "qkv")
        out, lse = hop_fa.flash_attention_fwd_cuda(q, k, v, True, 128 ** -0.5)
        want, want_lse = hop_fa.flash_attention_fwd_reference(
            q, k, v, True, 128 ** -0.5)
        torch.cuda.synchronize(i)
        _assert_rows_close(out, want, 2.0 ** -6)
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_flash_bwd_runs_on_every_card(cuda):
    """One process calls the bf16 dq and dkv kernels on each card in
    turn, and each call agrees with the plain backward: their opt-in to
    more shared memory holds per device, so it is made on every call."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    x = _inputs(29, 1, 256, 256, 4, 2, 128)
    for i in range(torch.cuda.device_count()):
        q, k, v, do = (torch.from_numpy(x[n]).to(torch.device("cuda", i),
                                                 torch.bfloat16)
                       for n in ("q", "k", "v", "dout"))
        out, lse = hop_fa.flash_attention_fwd_reference(q, k, v, True,
                                                        128 ** -0.5)
        got = hop_fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, True,
                                              128 ** -0.5)
        want = hop_fa.flash_attention_bwd_reference(q, k, v, out, lse, do,
                                                    True, 128 ** -0.5)
        torch.cuda.synchronize(i)
        for g, w in zip(got, want):
            _assert_rows_close(g, w, GRAD_ROW_REL, ROW_FLOOR)


@pytest.mark.gpu
def test_flash_fwd_takes_unaligned_views(cuda):
    """A view whose rows do not start on 16 bytes (which the bf16
    forward's TMA maps cannot take) is copied by the wrapper and gives the
    bits of the contiguous input."""
    x = _inputs(17, 1, 200, 200, 4, 2, 128)
    q, k, v = (torch.from_numpy(x[n]).to(cuda, torch.bfloat16) for n in "qkv")
    wide = torch.zeros(1, 200, 4, 136, device=cuda, dtype=torch.bfloat16)
    wide[..., 1:129] = q
    view = wide[..., 1:129]
    assert view.data_ptr() % 16 != 0
    got = hop_fa.flash_attention_fwd_cuda(view, k, v, True, 128 ** -0.5)
    want = hop_fa.flash_attention_fwd_cuda(q, k, v, True, 128 ** -0.5)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_flash_kernels_reject_what_they_do_not_take(cuda):
    """A head_dim above 256, or a type other than f32, bf16 and fp16,
    raises on the card; nothing falls back to the plain version."""
    q = torch.zeros(1, 64, 2, 264, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        hop_fa.flash_attention_fwd_cuda(q, q, q, True, 1.0)
    q = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="dtype"):
        hop_fa.flash_attention_fwd_cuda(q, q, q, True, 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True],
                         ids=["noncausal", "causal"])
def test_head_dim_72_kernels_match_plain(cuda, causal):
    """bf16 at d = 72: the forward, dq and dkv kernels (zero-padded to
    128) against the unpadded plain versions, to 4 bf16 ulps of the
    largest value; d = 264 raises."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (torch.randn(2, 256, 4, 72, device=cuda, generator=gen)
                   .to(torch.bfloat16) for _ in range(4))
    scale = 72 ** -0.5
    out, lse = hop_fa.flash_attention_fwd_cuda(q, k, v, causal, scale)
    want_out, want_lse = hop_fa.flash_attention_fwd_reference(
        q, k, v, causal, scale)
    got = (out, *hop_fa.flash_attention_bwd_cuda(q, k, v, want_out, want_lse,
                                                 do, causal, scale))
    want = (want_out, *hop_fa.flash_attention_bwd_reference(
        q, k, v, want_out, want_lse, do, causal, scale))
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        w = w.float()
        torch.testing.assert_close(g.float(), w, rtol=0,
                                   atol=2.0 ** -6 * float(w.abs().max()))
    wide = torch.zeros(1, 64, 2, 264, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        hop_fa.flash_attention_fwd_cuda(wide, wide, wide, True, 1.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 32])
def test_narrow_head_dims_kernels_match_plain(cuda, d, dtype):
    """The UNet's narrow heads on the card: d = 8 and 32, zero-padded to
    64, non-causal self-attention (256 tokens) and cross-attention
    against 77 keys (a ragged last key tile): out, lse, dq, dk and dv
    against the unpadded plain versions (f32 to 1e-4, bf16 to 4 bf16
    ulps of the largest value); d = 264 raises."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    tdt = getattr(torch, dtype)
    for sk in (256, 77):
        q, do = (torch.randn(2, 256, 8, d, device=cuda, generator=gen)
                 .to(tdt) for _ in range(2))
        k, v = (torch.randn(2, sk, 8, d, device=cuda, generator=gen)
                .to(tdt) for _ in range(2))
        scale = d ** -0.5
        out, lse = hop_fa.flash_attention_fwd_cuda(q, k, v, False, scale)
        want_out, want_lse = hop_fa.flash_attention_fwd_reference(
            q, k, v, False, scale)
        got = (out, *hop_fa.flash_attention_bwd_cuda(
            q, k, v, want_out, want_lse, do, False, scale))
        want = (want_out, *hop_fa.flash_attention_bwd_reference(
            q, k, v, want_out, want_lse, do, False, scale))
        torch.cuda.synchronize()
        torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-5)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            w = w.float()
            tol = 1e-4 if dtype == "float32" else 2.0 ** -6 * float(
                w.abs().max())
            torch.testing.assert_close(g.float(), w, atol=tol, rtol=0)
    wide = torch.zeros(1, 64, 2, 264, device=cuda, dtype=tdt)
    with pytest.raises(ValueError, match="head_dim 264"):
        hop_fa.flash_attention_fwd_cuda(wide, wide, wide, False, 1.0)
