"""The batch-invariant kernels' order twins (``kernels/bi_gemm.py``'s
``bi_gemm_chain_ref`` and ``fma32``, ``kernels/bi_reduce.py``'s
``bi_reduce_chain_ref`` and ``bi_logsumexp_chain_ref``), on the CPU.

Each twin is its kernel's documented order in plain PyTorch, bit for bit
on any device; ``chip_smoke.py`` holds the kernels against them on the
card. Here: ``fma32`` rounds a·b + c once, as an exact rational reference
does (cases built so that a fused multiply-add and a multiply-then-add
differ, so a twin that rounded twice would fail); the product's chain is
that rounding step by step; the sum's chains are float32 adds in the
documented order; neither twin changes with zeros appended to K or M or
with the number of batch rows; both agree with the reference's
``jnp.matmul`` and ``jnp.sum``. The logsumexp's twin is its maximum and
chain of exps in order, agrees with ``jax.nn.logsumexp`` on finite rows
and reads its +-inf where the maximum is infinite; the argmax's plain version is the first maximal element and
``jnp.argmax``'s on ties, signed zeros, infinities and NaNs. The sources
keep the order's rules.
"""
from __future__ import annotations

import re
from fractions import Fraction

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from torch_parity import single_threaded  # noqa: F401

from repro_torch.kernels import build
from repro_torch.kernels.bi_gemm import bi_gemm_chain_ref, fma32
from repro_torch.kernels.bi_reduce import (ARGMAX, LOGSUMEXP, SUM,
                                           bi_logsumexp_chain_ref,
                                           bi_reduce,
                                           bi_reduce_chain_ref)

F32 = np.float32


def _round32(q: Fraction) -> np.float32:
    """The float32 nearest to q, ties to even: ``float(q)`` is within an
    ulp, so the answer is it or one of its two float32 neighbours."""
    f = F32(float(q))
    cands = (f, np.nextafter(f, F32(np.inf)), np.nextafter(f, F32(-np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - q),
                                     int(np.array(v).view(np.int32)) & 1))


def _exact_chain(a_row, b_col):
    """One element of the kernel's chain, each fma rounded once from the
    exact rational a·b + acc."""
    acc = F32(0)
    for x, y in zip(a_row, b_col):
        acc = _round32(Fraction(float(x)) * Fraction(float(y))
                       + Fraction(float(acc)))
    return acc


def _wide_products(rng, k):
    """a row and a column whose products need ~26 significant bits, with
    signs and scales that make the chain cancel: there a multiply-then-add
    (two roundings) and a fused multiply-add part."""
    u = rng.integers(0, 4096, k)
    v = rng.integers(0, 4096, k)
    sign = rng.choice([-1.0, 1.0], k)
    a = (sign * (1 + u * 2.0**-12)).astype(F32)
    b = ((1 + v * 2.0**-12) * 2.0 ** rng.integers(-2, 3, k)).astype(F32)
    return a, b


def _twin_scalar(x, y, c):
    return fma32(torch.tensor([x]), torch.tensor([y]),
                 torch.tensor([c]))[0].item()


# ---------------------------------------------------------------------- #
# fma32 and the product's chain against exact rationals
# ---------------------------------------------------------------------- #
@settings(max_examples=300, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(0, 2))
def test_fma32_rounds_once(seed, which):
    rng = np.random.default_rng(seed)
    a, b = _wide_products(rng, 1)
    x, y = a[0], b[0]
    # c: minus the rounded product (the fma keeps the product's error, a
    # multiply-then-add gives 0), a neighbour of it, or any float32
    c = [-(x * y), -(x * y) * F32(1 + 2.0**-20),
         F32(rng.standard_normal())][which]
    want = _round32(Fraction(float(x)) * Fraction(float(y))
                    + Fraction(float(c)))
    assert _twin_scalar(x, y, c) == want


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(1, 12), st.integers(1, 3))
def test_the_chain_twin_is_the_exact_chain(seed, k, n):
    rng = np.random.default_rng(seed)
    cols = [_wide_products(rng, k) for _ in range(n)]
    a = torch.from_numpy(cols[0][0]).reshape(1, 1, k)
    b = torch.from_numpy(np.stack([c[1] for c in cols], 1)).reshape(1, k, n)
    got = bi_gemm_chain_ref(a, b)[0, 0]
    for j in range(n):
        assert got[j].item() == _exact_chain(cols[0][0], cols[j][1])


def test_the_cases_tell_a_fused_add_from_two_roundings():
    """The cases above would catch a twin that rounds twice: on them a
    multiply-then-add chain differs from the exact chain, which the twin
    equals."""
    rng = np.random.default_rng(0)
    differs = 0
    for _ in range(200):
        a, b = _wide_products(rng, 8)
        exact = _exact_chain(a, b)
        twice = F32(0)
        for x, y in zip(a, b):
            twice = F32(F32(x * y) + twice)
        differs += twice != exact
        got = bi_gemm_chain_ref(torch.from_numpy(a).reshape(1, 1, 8),
                                torch.from_numpy(b).reshape(1, 8, 1))
        assert got.item() == exact
    assert differs > 50, differs


def test_fma32_special_values():
    tiny = float(F32(2.0**-80))
    # an underflowing negative sum keeps its sign: -0
    z = fma32(torch.tensor([-tiny]), torch.tensor([tiny]),
              torch.tensor([0.0]))
    assert z.item() == 0.0 and torch.signbit(z).item()
    inf, nan = float("inf"), float("nan")
    assert _twin_scalar(inf, 2.0, 1.0) == inf
    assert np.isnan(_twin_scalar(inf, 0.0, 1.0))
    assert np.isnan(_twin_scalar(nan, 1.0, 1.0))
    assert _twin_scalar(3.0, 4.0, -12.0) == 0.0
    big = float(np.finfo(F32).max)
    assert _twin_scalar(big, 2.0, 0.0) == inf


@pytest.mark.parametrize("k,sign", [(16, True), (17, False), (32, True),
                                    (5, False)])
def test_the_chain_runs_to_a_multiple_of_16(k, sign):
    """A chain that ends at -0 (every product a negative underflow) keeps
    it where K is a multiple of 16 and reads +0 where the kernel's zeros
    follow, as the kernel does: fmaf(0, 0, -0) is +0."""
    tiny = float(F32(2.0**-80))
    a = torch.full((1, 1, k), -tiny)
    b = torch.full((1, k, 1), tiny)
    got = bi_gemm_chain_ref(a, b)
    assert got.item() == 0.0
    assert torch.signbit(got).item() == sign


# ---------------------------------------------------------------------- #
# the sum's chains against float32 adds in the documented order
# ---------------------------------------------------------------------- #
def _sum_in_order(x):
    """numpy float32 scalars, one add at a time, in the kernel's order."""
    r, m, d = x.shape
    out = np.zeros((r, d), F32)
    for i in range(r):
        if d > 1:
            for j in range(d):
                acc = F32(0)
                for k in range(m):
                    acc = F32(acc + x[i, k, j])
                out[i, j] = acc
        else:
            lanes = [F32(0)] * 32
            for k in range(m):
                lanes[k % 32] = F32(lanes[k % 32] + x[i, k, 0])
            h = 16
            while h:
                lanes = [F32(lanes[j] + lanes[j + h]) for j in range(h)]
                h //= 2
            out[i, 0] = lanes[0]
    return out


@pytest.mark.parametrize("r,m,d", [(3, 1, 1), (2, 33, 1), (2, 100, 1),
                                   (1, 1100, 1), (3, 17, 5), (2, 40, 64)])
def test_the_sum_twin_is_the_documented_order(r, m, d):
    x = np.random.default_rng(r * m + d).standard_normal(
        (r, m, d)).astype(F32) * F32(1e3)
    got = bi_reduce_chain_ref(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.int32), _sum_in_order(x).view(np.int32))


# ---------------------------------------------------------------------- #
# invariance: appended zeros, batch rows
# ---------------------------------------------------------------------- #
def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(F32))


@pytest.mark.parametrize("batch,m,k,n", [(3, 5, 37, 7), (2, 4, 16, 3),
                                         (4, 50, 50, 10)])
def test_the_chain_twin_ignores_zeros_in_k_and_batch_rows(batch, m, k, n):
    a, b = _randn(batch, m, k), _randn(batch, k, n, seed=1)
    want = bi_gemm_chain_ref(a, b)
    for z in (1, 5, 16):
        pa = torch.cat([a, a.new_zeros(batch, m, z)], 2)
        pb = torch.cat([b, b.new_zeros(batch, z, n)], 1)
        assert torch.equal(bi_gemm_chain_ref(pa, pb), want)
    for rows in range(1, batch):
        assert torch.equal(bi_gemm_chain_ref(a[:rows], b[:rows]), want[:rows])
    # a shared a (batch 1), and a's rows alone
    assert torch.equal(bi_gemm_chain_ref(a[:1], b),
                       bi_gemm_chain_ref(a[:1].expand(batch, m, k), b))
    assert torch.equal(bi_gemm_chain_ref(a[:, :2], b), want[:, :2])


@pytest.mark.parametrize("r,m,d", [(3, 50, 1), (2, 1000, 1), (4, 33, 5),
                                   (2, 256, 64)])
def test_the_sum_twin_ignores_zeros_in_m_and_batch_rows(r, m, d):
    x = _randn(r, m, d, seed=2)
    want = bi_reduce_chain_ref(x)
    for z in (1, 31, 64):
        assert torch.equal(
            bi_reduce_chain_ref(torch.cat([x, x.new_zeros(r, z, d)], 1)),
            want)
    for rows in range(1, r):
        assert torch.equal(bi_reduce_chain_ref(x[:rows]), want[:rows])


# ---------------------------------------------------------------------- #
# against the reference's jnp ops
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("batch,m,k,n", [(2, 50, 784, 64), (3, 37, 29, 71),
                                         (2, 256, 64, 32), (4, 32, 16, 32)])
def test_the_chain_twin_agrees_with_jnp_matmul(batch, m, k, n):
    import jax.numpy as jnp
    a, b = _randn(batch, m, k, seed=3), _randn(batch, k, n, seed=4)
    want = np.asarray(jnp.matmul(a.numpy(), b.numpy()))
    got = bi_gemm_chain_ref(a, b).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("r,m,d", [(56, 10_000, 1), (24, 256, 64),
                                   (50, 50, 1), (7, 33, 5)])
def test_the_sum_twin_agrees_with_jnp_sum(r, m, d):
    import jax.numpy as jnp
    x = _randn(r, m, d, seed=5)
    want = np.asarray(jnp.sum(x.numpy(), 1))
    got = bi_reduce_chain_ref(x).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_the_sum_twin_takes_only_sums():
    with pytest.raises(ValueError):
        bi_reduce_chain_ref(torch.zeros(2, 3))
    assert SUM == 0


# ---------------------------------------------------------------------- #
# logsumexp and argmax: the walk's order, edge rows
# ---------------------------------------------------------------------- #
INF, NAN = F32(np.inf), F32(np.nan)


def _edge_rows(m, seed):
    """(rows, M) float32: random rows at two scales, then the edges —
    all -1e30, a causal band (the first half finite, then -1e30), a tie
    of the maximum, signed zeros, a +inf, all -inf, -inf among finite
    values, a NaN, two NaNs after a larger value — each whose width
    allows it."""
    rng = np.random.default_rng(seed)
    rows = [rng.standard_normal(m), 30 * rng.standard_normal(m),
            np.full(m, -1e30), np.where(np.arange(m) <= m // 2,
                                        rng.standard_normal(m), -1e30),
            np.where(np.arange(m) % 2, -0.0, 0.0), np.full(m, -np.inf)]
    one = rng.standard_normal(m)
    one[m // 2] = np.inf
    rows.append(one)
    if m > 1:
        tie = rng.standard_normal(m)
        tie[[0, m - 1]] = tie.max() + 1
        rows.append(tie)
        lo = rng.standard_normal(m)
        lo[::2] = -np.inf
        rows.append(lo)
    nan = rng.standard_normal(m)
    nan[m // 2] = np.nan
    rows.append(nan)
    if m > 2:
        two = rng.standard_normal(m)
        two[0], two[1], two[-1] = 100.0, np.nan, np.nan
        rows.append(two)
    return np.stack(rows).astype(F32)


def _above(v, best):
    return v > best or (np.isnan(v) and not np.isnan(best))


def _first_max(row):
    """(the first maximal value, its index): the walk from x[0]."""
    best, at = row[0], 0
    for k, v in enumerate(row):
        if _above(v, best):
            best, at = v, k
    return best, at


def _same(a, b):
    """Equal bit for bit, NaN only where NaN (a NaN's payload aside)."""
    nan = np.isnan(a)
    return np.array_equal(nan, np.isnan(b)) and np.array_equal(
        a[~nan].view(np.int32), b[~nan].view(np.int32))


EDGE_MS = [1, 2, 10, 33, 64]


def _documented_logsumexp(x, infinite_max_subtracted=False):
    """The order written out: the maximum by the walk from -inf, the exps
    given (``torch.exp`` of x - sub, as the twin takes them), numpy
    float32 adds in order from +0, ``log``, then + sub; sub is the
    maximum, or +0 where it is infinite. With
    ``infinite_max_subtracted`` the order before the infinite maximum's
    rule: the maximum subtracted whatever it is, +0 added for an infinite
    one."""
    want = np.empty(len(x), F32)
    for i, row in enumerate(x):
        mx = F32(-np.inf)
        for v in row:
            if _above(v, mx):
                mx = v
        sub = F32(0) if np.isinf(mx) else mx
        with np.errstate(invalid="ignore"):     # inf - inf
            e = torch.exp(torch.from_numpy(
                row - (mx if infinite_max_subtracted else sub))).numpy()
        s = F32(0)
        for v in e:
            s = F32(s + v)
        log = torch.log(torch.tensor(s)).numpy()
        want[i] = F32(log + sub)
    return want


@pytest.mark.parametrize("m", EDGE_MS)
def test_the_logsumexp_twin_is_the_documented_order(m):
    """The twin against its order written out (``_documented_logsumexp``)
    on every edge row, the infinite maxima's included."""
    x = _edge_rows(m, seed=m)
    want = _documented_logsumexp(x)
    got = bi_logsumexp_chain_ref(torch.from_numpy(x)[:, :, None])
    assert got.shape == (len(x), 1)
    assert _same(got[:, 0].numpy(), want)


@pytest.mark.parametrize("m", EDGE_MS)
def test_the_logsumexp_twin_keeps_the_old_order_off_infinite_maxima(m):
    """The infinite maximum's rule moves those rows alone: every row whose
    maximum is finite or NaN is bit for bit the order that subtracted the
    maximum whatever it was, and a row whose maximum is +-inf, which that
    order read as NaN (inf - inf), now reads +-inf."""
    x = _edge_rows(m, seed=m + 3)
    old = _documented_logsumexp(x, infinite_max_subtracted=True)
    got = bi_logsumexp_chain_ref(torch.from_numpy(x)[:, :, None])[:, 0]
    got = got.numpy()
    inf = np.isinf(np.array([_first_max(row)[0] for row in x]))
    assert inf.sum() == 2 and np.isnan(old[inf]).all()
    assert _same(got[~inf], old[~inf])
    assert np.array_equal(got[inf], [_first_max(row)[0] for row in x[inf]])


@pytest.mark.parametrize("m", EDGE_MS)
def test_the_logsumexp_twin_agrees_with_jax_logsumexp(m):
    """Within 1e-5 · max(1, |want|) of ``jax.nn.logsumexp`` on the rows
    whose maximum is finite, -inf entries among them (the chain of M
    float32 adds against XLA's order); NaN on a NaN row as jax; and
    exactly jax's +-inf where the maximum is +-inf (a +inf, or all
    -inf): the kernel subtracts +0 there, as jax does."""
    import jax
    x = _edge_rows(m, seed=m + 1)
    want = np.asarray(jax.nn.logsumexp(x, axis=1))
    got = bi_logsumexp_chain_ref(torch.from_numpy(x)[:, :, None])[:, 0]
    got = got.numpy()
    nan = np.isnan(x).any(1)
    inf = np.isinf(np.array([_first_max(row)[0] for row in x])) & ~nan
    fin = ~inf & ~nan
    assert fin.sum() >= 4 and inf.sum() == 2
    tol = 1e-5 * np.maximum(1.0, np.abs(want[fin]))
    assert (np.abs(got[fin] - want[fin]) <= tol).all()
    assert np.isnan(got[nan]).all() and np.isnan(want[nan]).all()
    assert np.array_equal(got[inf], want[inf])
    assert np.array_equal(want[inf], x[inf].max(1))


@pytest.mark.parametrize("m", EDGE_MS)
def test_argmax_is_the_first_maximal_and_jnp_argmax(m):
    """``bi_reduce(x, ARGMAX)`` on the CPU (the kernel's plain version)
    is the walk's first maximal element and ``jnp.argmax``'s, on ties,
    +-0 ties, +-inf rows, all -1e30 rows and NaN rows; the twin's maximum
    is that element's value."""
    import jax.numpy as jnp
    x = _edge_rows(m, seed=m + 2)
    got = bi_reduce(torch.from_numpy(x)[:, :, None], ARGMAX)[:, 0].numpy()
    walk = np.array([_first_max(row)[1] for row in x])
    assert np.array_equal(got, walk)
    assert np.array_equal(got, np.asarray(jnp.argmax(x, axis=1)))


def test_the_logsumexp_twin_ignores_batch_rows():
    x = torch.from_numpy(_edge_rows(33, seed=9))[:, :, None]
    want = bi_logsumexp_chain_ref(x)
    for rows in (1, 3, len(x) - 1):
        assert _same(bi_logsumexp_chain_ref(x[:rows]).numpy(),
                     want[:rows].numpy())
    with pytest.raises(ValueError):
        bi_logsumexp_chain_ref(torch.zeros(2, 3, 2))
    assert LOGSUMEXP == 1


# ---------------------------------------------------------------------- #
# the sources keep the order's rules
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["bi_gemm", "bi_reduce"])
def test_the_sources_keep_the_order(name):
    """No atomics, tensor cores, TF32, fast math, or a reduction across
    threads other than the sum's shuffle-down tree."""
    src = (build.CSRC / f"{name}.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    for banned in (r"\batomic", r"\bw?gmma\b", r"\bmma\.", r"tf32",
                   r"__shfl_xor", r"__shfl_up", r"__f[a-z]+_r[zdu]\b",
                   r"__fdividef", r"__expf\b", r"\bexp2f\b", r"__logf\b"):
        assert not re.search(banned, code, re.I), (name, banned)
    assert not any("fast_math" in f or "fmad" in f for f in build.NVCC_FLAGS)
    if name == "bi_gemm":
        assert "fmaf(" in code and "cp.async" in code
    else:
        assert code.count("__shfl_down_sync") == 1
        # logsumexp's chain and its last step, in the staged walk and in
        # the walk over device memory: +0 subtracted for an infinite max
        assert code.count("const float sub = isinf(mx) ? 0.f : mx;") == 2
        assert code.count("s += expf(") == 2
        assert code.count(" - sub);") == 2
        assert code.count("logf(s) + sub;") == 2
