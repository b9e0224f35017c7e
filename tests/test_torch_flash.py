"""Port parity of the flash-attention kernel K3 (``flash_attention``): its
plain PyTorch version and its autograd Function — what the wrapper runs on
CPU tensors — against the Pallas TPU kernel (interpret mode, through the
JAX package's differentiable ``ops.flash_attention``) and
``repro.kernels.ref.flash_attention_ref``, forward and VJP. The CUDA
kernel runs only on the card; ``chip_smoke.py`` holds it against the plain
version there.

Shapes: the five of tests/test_kernels.py, the LM task's (S = T = 32,
D = 16, 4 heads), a ragged S = 37 and a window without ``causal``; and
grouped-query attention, (H, Hkv) = (4, 2), (4, 1), (12, 4), against the
Pallas kernel on K/V repeated as the JAX package's attention repeats them.
Tolerances, those of tests/test_kernels.py: 2e-5 for float32 (another
summation order), 2e-2 for bfloat16 (the probabilities and the output
rounded to 8 mantissa bits). Gradients (float32) within 1e-4: the two
VJPs reduce over up to 512 keys in another order.
"""
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.flash_attention import (band_mask, flash_attention,
                                                 flash_attention_ref)
from repro_torch.models.attention import causal_window_mask

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SHAPES = [  # B, H, S, T, D, causal, window
    (2, 4, 256, 256, 64, True, None),
    (1, 2, 128, 256, 64, True, None),      # right-aligned queries
    (2, 2, 256, 256, 128, True, 64),       # sliding window
    (1, 1, 256, 256, 64, False, None),     # bidirectional
    (1, 2, 512, 512, 64, True, None),
    (8, 4, 32, 32, 16, True, None),        # lm_tiny's heads
    (3, 2, 37, 37, 16, True, None),        # ragged S
]


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    return types.SimpleNamespace(ops=reference("kernels.ops"),
                                 kref=reference("kernels.ref"),
                                 jax=jax, jnp=jnp)


@pytest.fixture(autouse=True)
def interpret(monkeypatch):
    """The Pallas kernel runs in interpret mode (read at every call)."""
    monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")


def _inputs(B, H, S, T, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, H, S, D), (B, H, T, D), (B, H, T, D))]


def _pallas(ref, arrays, dtype, causal, window):
    """(the inputs as jax arrays, the Pallas kernel's output)."""
    j = [ref.jnp.asarray(a).astype(getattr(ref.jnp, dtype)) for a in arrays]
    return j, ref.ops.flash_attention(*j, causal=causal, window=window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S,T,D,causal,window", SHAPES)
def test_forward_matches_pallas_and_ref(ref, B, H, S, T, D, causal, window,
                                        dtype):
    arrays = _inputs(B, H, S, T, D)
    j, pallas = _pallas(ref, arrays, dtype, causal, window)
    oracle = ref.kref.flash_attention_ref(*j, causal=causal, window=window)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    before = flash_attention.launches
    for got in (flash_attention(*t, causal=causal, window=window),
                flash_attention_ref(*t, causal=causal, window=window)):
        assert got.shape == (B, H, S, D) and got.dtype == t[0].dtype
        got = got.float().numpy()
        for want in (pallas, oracle):
            np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                       atol=TOL[dtype], rtol=TOL[dtype])
    assert flash_attention.launches == before      # CPU: no kernel


@pytest.mark.parametrize("B,H,S,T,D,causal,window", SHAPES)
def test_vjp_matches_pallas_and_ref(ref, B, H, S, T, D, causal, window):
    """The Function's backward (the plain version's VJP) against the
    gradients of the JAX package's custom_vjp wrapper and of its oracle,
    for a random cotangent."""
    arrays = _inputs(B, H, S, T, D, seed=1)
    g = np.random.default_rng(2).standard_normal(
        (B, H, S, D)).astype(np.float32)
    t = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = flash_attention(*t, causal=causal, window=window)
    got = torch.autograd.grad(out, t, torch.from_numpy(g))
    j = [ref.jnp.asarray(a) for a in arrays]
    for fn in (ref.ops.flash_attention, ref.kref.flash_attention_ref):
        _, vjp = ref.jax.vjp(
            lambda a, b, c: fn(a, b, c, causal=causal, window=window), *j)
        for gg, want in zip(got, vjp(ref.jnp.asarray(g))):
            np.testing.assert_allclose(gg.numpy(), np.asarray(want),
                                       atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_window_without_causal_follows_the_kernel(ref, dtype):
    """The TPU kernel applies ``window`` with or without ``causal``; the
    JAX package's oracle only under ``causal``. The port follows the
    kernel, its plain version too."""
    arrays = _inputs(2, 2, 96, 128, 32)
    j, pallas = _pallas(ref, arrays, dtype, False, 17)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    got = flash_attention(*t, causal=False, window=17).float().numpy()
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    unwindowed = np.asarray(ref.kref.flash_attention_ref(
        *j, causal=False, window=17), np.float32)
    assert np.abs(got - unwindowed).max() > 0.1


GQA = [(4, 2), (4, 1), (12, 4)]  # (H, Hkv)


def _gqa_inputs(H, Hkv, D, seed):
    """q (2, H, 40, D), k/v (2, Hkv, 64, D): right-aligned causal rows."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((2, H, 40, D), (2, Hkv, 64, D), (2, Hkv, 64, D))]


def _repeated(ref, j, g):
    """The JAX package's GQA grouping: each KV head ``jnp.repeat``ed g
    times in a row."""
    return [j[0]] + [ref.jnp.repeat(x, g, axis=1) for x in j[1:]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("H,Hkv", GQA)
def test_gqa_forward_matches_pallas_on_repeated_kv(ref, H, Hkv, D, dtype):
    """K/V with Hkv < H heads go in as they are; the plain version and the
    autograd Function give the Pallas kernel's output on ``jnp.repeat``ed
    K/V."""
    arrays = _gqa_inputs(H, Hkv, D, seed=4)
    j = [ref.jnp.asarray(a).astype(getattr(ref.jnp, dtype)) for a in arrays]
    want = np.asarray(ref.ops.flash_attention(*_repeated(ref, j, H // Hkv)),
                      np.float32)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    for got in (flash_attention(*t), flash_attention_ref(*t)):
        assert got.shape == (2, H, 40, D) and got.dtype == t[0].dtype
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("D", [16, 128])
@pytest.mark.parametrize("H,Hkv", GQA)
def test_gqa_vjp_matches_pallas_on_repeated_kv(ref, H, Hkv, D):
    """The Function's dk and dv come back (B, Hkv, T, D): the VJP of the
    Pallas wrapper through ``jnp.repeat``, which sums each KV head's
    gradient over the query heads that read it."""
    arrays = _gqa_inputs(H, Hkv, D, seed=5)
    g = np.random.default_rng(6).standard_normal(
        (2, H, 40, D)).astype(np.float32)
    t = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = torch.autograd.grad(flash_attention(*t), t, torch.from_numpy(g))
    _, vjp = ref.jax.vjp(
        lambda a, b, c: ref.ops.flash_attention(
            *_repeated(ref, [a, b, c], H // Hkv)),
        *(ref.jnp.asarray(a) for a in arrays))
    for gg, want, a in zip(got, vjp(ref.jnp.asarray(g)), arrays):
        assert gg.shape == a.shape
        np.testing.assert_allclose(gg.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)


def test_gqa_rejects_heads_that_do_not_group():
    q, k = torch.zeros(1, 6, 8, 16), torch.zeros(1, 4, 8, 16)
    for fn in (flash_attention, flash_attention_ref):
        with pytest.raises(ValueError, match="multiple of 4 KV heads"):
            fn(q, k, k)


@pytest.mark.parametrize("case", ["misaligned bf16", "head dim 48"])
def test_kernel_route_rejects_before_any_launch(case):
    """The CUDA route's own checks run before the kernel is built or
    launched, so CPU tensors reach them: the bf16 kernel reads 16-byte
    words, and only the head dims of ``HEAD_DIMS`` are instantiated."""
    if case == "misaligned bf16":
        buf = torch.zeros(1 + 2 * 32 * 16, dtype=torch.bfloat16)
        q = buf[1:].view(1, 2, 32, 16)        # 2 bytes past the allocation
        k = torch.zeros(1, 1, 32, 16, dtype=torch.bfloat16)
        match = "16-byte"
    else:
        q = k = torch.zeros(1, 2, 32, 48)
        match = "head dim"
    before = flash_attention.launches
    with pytest.raises(ValueError, match=match):
        fa._kernel(q, k, k, True, None, 0.25)
    assert flash_attention.launches == before


def test_gqa_heads_sum_back_through_repeat_interleave():
    """With the KV heads repeated outside the Function, each KV head's
    gradient is the sum over the query heads that read it."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16, 16)).astype(
        np.float32))
    kv = [torch.from_numpy(rng.standard_normal((2, 2, 16, 16)).astype(
        np.float32)).requires_grad_(True) for _ in range(2)]
    out = flash_attention(q, *(x.repeat_interleave(2, dim=1) for x in kv))
    dk, dv = torch.autograd.grad(out.square().sum(), kv)
    rep = [x.detach().repeat_interleave(2, dim=1).requires_grad_(True)
           for x in kv]
    out = flash_attention_ref(q, *rep)
    rk, rv = torch.autograd.grad(out.square().sum(), rep)
    for got, full in ((dk, rk), (dv, rv)):
        want = full.reshape(2, 2, 2, 16, 16).sum(2)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("S,T,causal,window", [
    (5, 5, True, None), (5, 9, True, None), (6, 6, True, 2),
    (4, 7, False, 3), (3, 3, False, None)])
def test_band_mask(S, T, causal, window):
    i = np.arange(S)[:, None] + (T - S)
    j = np.arange(T)[None, :]
    want = np.ones((S, T), bool)
    if causal:
        want &= j <= i
    if window is not None:
        want &= (i - j) < window
    np.testing.assert_array_equal(band_mask(S, T, causal, window).numpy(),
                                  want)


@pytest.mark.parametrize("S,window", [(6, None), (9, 3), (1, 1)])
def test_causal_window_mask_matches_the_reference(S, window):
    attn = reference("models.attention")
    np.testing.assert_array_equal(
        causal_window_mask(S, window).numpy(),
        np.asarray(attn.causal_window_mask(S, window)))


@pytest.mark.parametrize("kw,err", [
    (dict(q=(2, 2, 9, 16), k=(2, 2, 8, 16)), ValueError),     # S > T
    (dict(q=(2, 2, 8, 16), k=(2, 3, 8, 16)), ValueError),     # heads
    (dict(q=(2, 2, 8), k=(2, 2, 8)), ValueError),             # rank
    (dict(window=0), ValueError),
    (dict(dtype=torch.float64), TypeError),
])
def test_rejects_what_the_kernel_does_not_take(kw, err):
    q = torch.zeros(kw.get("q", (1, 1, 4, 16)), dtype=kw.get("dtype"))
    k = torch.zeros(kw.get("k", (1, 1, 4, 16)), dtype=kw.get("dtype"))
    with pytest.raises(err):
        flash_attention(q, k, k, window=kw.get("window"))
    with pytest.raises(err):
        flash_attention_ref(q, k, k, window=kw.get("window"))
