"""Port parity of the grouped expert GEMM K5 (``moe_gemm``): its plain
PyTorch version — what the wrapper runs on CPU tensors — against the
Pallas TPU kernel (interpret mode, through the JAX package's
``ops.moe_gemm``) at tests/test_kernels.py's shapes, and against
``repro.kernels.ref.moe_gemm_ref`` at ragged shapes the Pallas kernel
refuses (its blocks must divide C, K and N; the port's kernel masks the
edges). The CUDA kernel runs only on the card; ``chip_smoke.py`` holds it
against the plain version there.

Tolerances, those of tests/test_kernels.py: 1e-4 for float32 (another
summation order), 2e-1 for bfloat16 (the reference sums bf16 products in
its own precision), both absolute and relative.
"""
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_ref

TOL = {"float32": 1e-4, "bfloat16": 2e-1}
SHAPES = [  # E, C, d, f: tests/test_kernels.py's
    (4, 128, 256, 128),
    (8, 64, 128, 384),
    (2, 256, 512, 256),
]
RAGGED = [  # C 1,368 (qwen2-moe's prefill capacity), K and N off the tiles
    (3, 1368, 72, 40),
    (2, 37, 100, 70),
    (5, 8, 33, 65),
    (1, 1, 7, 1),
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


def _inputs(E, C, d, f, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, C, d)).astype(np.float32),
            rng.standard_normal((E, d, f)).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", SHAPES)
def test_plain_matches_pallas_and_ref(ref, E, C, d, f, dtype):
    arrays = _inputs(E, C, d, f)
    j = [ref.jnp.asarray(a).astype(getattr(ref.jnp, dtype)) for a in arrays]
    pallas = ref.ops.moe_gemm(*j, block_c=64, block_f=128, block_k=128)
    oracle = ref.kref.moe_gemm_ref(*j)
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    before = moe_gemm.launches
    for got in (moe_gemm(*t), moe_gemm_ref(*t)):
        assert got.shape == (E, C, f) and got.dtype == t[0].dtype
        for want in (pallas, oracle):
            _close(got.float().numpy(), want, TOL[dtype])
    assert moe_gemm.launches == before      # the CPU route


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", RAGGED)
def test_ragged_shapes_match_ref(ref, E, C, d, f, dtype):
    arrays = _inputs(E, C, d, f, seed=1)
    j = [ref.jnp.asarray(a).astype(getattr(ref.jnp, dtype)) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    got = moe_gemm(*t)
    assert got.shape == (E, C, f) and got.dtype == t[0].dtype
    _close(got.float().numpy(), ref.kref.moe_gemm_ref(*j), TOL[dtype])


def test_pallas_kernel_refuses_a_ragged_capacity(ref):
    """The TPU kernel's blocks must divide C: qwen2-moe's prefill capacity
    of 1,368 slots is no multiple of its default 128 (ROADMAP Queue 3);
    the port's wrapper takes it."""
    x, w = _inputs(1, 1368, 128, 128)
    with pytest.raises(AssertionError):
        ref.ops.moe_gemm(ref.jnp.asarray(x), ref.jnp.asarray(w))
    assert moe_gemm(torch.from_numpy(x), torch.from_numpy(w)).shape == (
        1, 1368, 128)


def test_bfloat16_sums_in_float32_and_rounds_once():
    """The plain version rounds the float32 sum once: equal to the float64
    sum rounded to bfloat16 up to the float32 summation's own error."""
    x, w = (torch.from_numpy(a).to(torch.bfloat16)
            for a in _inputs(3, 16, 256, 24, seed=2))
    got = moe_gemm(x, w)
    exact = torch.einsum("eck,ekn->ecn", x.double(), w.double())
    assert torch.equal(got, exact.float().to(torch.bfloat16)) or (
        (got.double() - exact).abs().max() <= 2 ** -8 * exact.abs().max())


def test_rejects_what_the_kernel_does_not_take():
    x, w = map(torch.from_numpy, _inputs(2, 8, 16, 4))
    with pytest.raises(ValueError, match="match"):
        moe_gemm(x, w[:, :15])                # contraction axes differ
    with pytest.raises(ValueError, match="match"):
        moe_gemm(x, w[:1])                    # expert counts differ
    with pytest.raises(ValueError):
        moe_gemm(x[0], w)                     # not (E, C, K)
    with pytest.raises(TypeError):
        moe_gemm(x.double(), w.double())
    with pytest.raises(TypeError):
        moe_gemm(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="meta"):
        moe_gemm(x, w.to("meta"))


def test_cpu_route_is_the_plain_version():
    """On CPU tensors the wrapper is the plain version, bit for bit, with
    autograd as usual, and launches nothing."""
    x, w = map(torch.from_numpy, _inputs(3, 24, 40, 12, seed=3))
    before = moe_gemm.launches
    assert torch.equal(moe_gemm(x, w), moe_gemm_ref(x, w))
    xg = x.clone().requires_grad_(True)
    moe_gemm(xg, w).sum().backward()
    np.testing.assert_allclose(xg.grad.numpy(),
                               np.broadcast_to(w.sum(-1)[:, None].numpy(),
                                               x.shape), rtol=1e-5)
    assert moe_gemm.launches == before


# ---------------------------------------------------------------------- #
# the decode: experts no token was routed to
# ---------------------------------------------------------------------- #
DECODE = [  # E, C, d, f: the decode's C = 8 (16 for a grouped dispatch)
    (6, 8, 128, 256),
    (6, 8, 256, 128),
    (5, 16, 128, 128),
]
EMPTY = (1, 3, 4)       # all +0, all -0, +-0 mixed


def _decode_inputs(E, C, d, f, seed):
    """x with experts 1, 3 and 4 empty (all +0, all -0, +-0 by a random
    sign), expert 2 holding one token whose row has a NaN, the rest random;
    w random."""
    rng = np.random.default_rng(seed)
    x, w = _inputs(E, C, d, f, seed=seed)
    x[1] = 0.0
    x[3] = -0.0
    x[4] = np.where(rng.random((C, d)) < 0.5, -0.0, 0.0)
    x[2] = 0.0
    x[2, 0] = rng.standard_normal(d)
    x[2, 0, d // 3] = np.nan
    return x, w


def _plus_zero(a):
    a = np.asarray(a, np.float32)
    return bool((a == 0).all() and not np.signbit(a).any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,d,f", DECODE)
def test_empty_experts_give_plus_zero_as_in_the_reference(ref, E, C, d, f,
                                                          dtype):
    """At decode shapes, experts whose x block is all +-0 (what the
    dispatch leaves for an expert no token was routed to) get +0 rows in
    the reference's Pallas kernel, in its plain einsum and in the port's
    plain version — the spec the card's kernel is held to, which skips
    them; a NaN in an otherwise empty expert's row is NaN across that
    output row in all three, and that expert's other rows +0; the rest
    within the module's tolerance."""
    x, w = _decode_inputs(E, C, d, f, seed=5)
    j = [ref.jnp.asarray(a).astype(getattr(ref.jnp, dtype)) for a in (x, w)]
    pallas = np.asarray(ref.ops.moe_gemm(*j).astype(ref.jnp.float32))
    oracle = np.asarray(ref.kref.moe_gemm_ref(*j).astype(ref.jnp.float32))
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w)]
    before = moe_gemm.launches
    got = moe_gemm(*t).float().numpy()
    assert moe_gemm.launches == before
    for out in (pallas, oracle, got):
        for e in EMPTY:
            assert _plus_zero(out[e]), e
        assert np.isnan(out[2, 0]).all()
        assert _plus_zero(out[2, 1:])
    nan = np.isnan(pallas)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(np.isnan(oracle), nan)
    for want in (pallas, oracle):
        _close(got[~nan], want[~nan], TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_an_empty_expert_with_an_inf_weight_is_nan_in_the_reference(
        ref, dtype):
    """ROADMAP P31: an empty expert whose weights hold an inf or a NaN
    gives NaN rows in the reference (0·inf) and in the port's plain
    version, where the card's kernel, which never reads that expert's
    weights, writes +0. The combine never reads an empty expert's rows,
    so a model's output is the same."""
    x, w = _decode_inputs(6, 8, 128, 256, seed=6)
    w[1, 5, 7] = np.inf
    w[3, 9, 11] = np.nan
    j = [ref.jnp.asarray(a).astype(getattr(ref.jnp, dtype)) for a in (x, w)]
    pallas = np.asarray(ref.ops.moe_gemm(*j).astype(ref.jnp.float32))
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, w)]
    got = moe_gemm(*t).float().numpy()
    for out in (pallas, got):
        assert np.isnan(out[1, :, 7]).all() and np.isnan(out[3, :, 11]).all()
        assert _plus_zero(np.delete(out[1], 7, 1))
        assert _plus_zero(np.delete(out[3], 11, 1))
        assert _plus_zero(out[4])
