"""Flash attention of the PyTorch port against the JAX package.

On the CPU the port's flash attention runs its plain versions: the
forward (masked softmax in f32) and the FA2 backward from the saved lse,
under the autograd Function the kernels use on the card. They are held
against the JAX package's Pallas kernels in interpret mode
(``flash_attention_pallas`` and ``jax.vjp`` through it, which runs the
backward kernels) on the same numpy-seeded f32 inputs, over the kernel
paths the JAX package takes: the rectangular grid (K1/K2), the folded
triangle (K3/K4), non-causal ``sq != sk``, GQA and the packed head pairs
of ``d=64``. The ``gpu``-marked tests hold the Hopper kernels against
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
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    _, lse = hop_fa.flash_attention_fwd_reference(
        *(torch.from_numpy(x[n]) for n in "qkv"), causal, scale)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL,
                               rtol=RTOL)


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
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES + [
    ("ragged_s200_gqa_d128", 200, 200, 8, 2, 128, True)], ids=lambda c: c[0])
def test_flash_kernels_match_plain(cuda, case, dtype):
    """The forward, dq and dkv kernels equal the plain versions on the
    same inputs: f32 to 1e-4 (order of summation), bf16 to 4 bf16 ulps
    of the largest value (each side rounds its outputs to bf16, and the
    kernels round P and dS to bf16 before their products)."""
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


@pytest.mark.gpu
def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros(1, 64, 2, 96, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        hop_fa.flash_attention_fwd_cuda(q, q, q, True, 1.0)
    q = torch.zeros(1, 64, 2, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        hop_fa.flash_attention_fwd_cuda(q, q, q, True, 1.0)
