"""K2 ``robust_aggregate``'s numerics on the card, step for step on the CPU.

The kernel (``csrc/robust_aggregate.cu``) runs only on the card, so its
algorithm is mirrored in plain PyTorch by
``kernels/robust_aggregate.py::robust_aggregate_network``: the
order-preserving key map and its inverse, the pad keys of a size class, the
class's sorting network (generated by the same loops as the kernel's), and
the predicated sum from -0.0 or the median's selects. These tests hold that
mirror against the plain version ``robust_aggregate_ref`` bit for bit (NaN
where it is NaN, equal values elsewhere, as ``torch.equal`` compares them:
the key order puts -0 before +0 where a sort leaves equal values in no
stated order) at every n from 1 to 128, every trim, both modes and both
input types, with NaN of either sign, +-inf, +-0, ties, sums that
overflow, and garbage in the rows the kernel must not read; against the
host oracles of the defense plane; and against the Pallas kernel in
interpret mode at a few shapes (within 1e-6, as
tests/test_torch_kernels.py holds the plain version: Pallas sums the
kept ranks with a tree). Two one-line wrong variants must fail.
"""
import re

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.core import defenses as tdfs
from repro_torch.kernels import build
from repro_torch.kernels import robust_aggregate as k2

CU = (build.CSRC / "robust_aggregate.cu").read_text()
M = 48            # columns: six kinds of eight, see _column_inputs
SIGN_NAN = np.uint32(0xFFC00000).view(np.float32)


def _column_inputs(n, rows, seed):
    """(rows, M) float32: in the first n rows, eight columns each of normal
    values; ties (small integers, zeros of both signs); quiet NaN, and NaN
    with the sign bit set, in a random number of rows (in the rank window
    and out of it); +-inf and +-3e38 (sums that overflow); all -0; every
    kind at once. Rows n.. hold NaN of both signs and huge values, which
    the kernel never reads."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, M)).astype(np.float32)
    real = x[:n]
    ties = rng.integers(-2, 3, (n, 8)).astype(np.float32)
    ties[ties == 0] = np.where(rng.random(int((ties == 0).sum())) < 0.5,
                               -0.0, 0.0)
    real[:, 8:16] = ties
    for col in range(16, 24):
        k = rng.integers(0, n + 1)
        rows_nan = rng.permutation(n)[:k]
        real[rows_nan, col] = np.where(col < 20, np.nan, SIGN_NAN)
    extremes = np.array([np.inf, -np.inf, 3e38, -3e38], np.float32)
    hit = rng.random((n, 8)) < 0.3
    block = real[:, 24:32]
    block[hit] = rng.choice(extremes, int(hit.sum()))
    real[:, 32:40] = -0.0
    kinds = np.concatenate([ties.ravel(), extremes,
                            np.array([np.nan, SIGN_NAN, 0.0, -0.0],
                                     np.float32)])
    mixed = rng.random((n, 8)) < 0.5
    block = real[:, 40:48]
    block[mixed] = rng.choice(kinds, int(mixed.sum()))
    junk = np.array([np.nan, SIGN_NAN, 3e38, -3e38, np.inf], np.float32)
    x[n:] = junk[np.arange(x[n:].size) % 5].reshape(x[n:].shape)
    return x


def _same(got, want):
    """NaN where ``want`` is NaN, equal values (+-0 equal) elsewhere."""
    nan = want.isnan()
    return torch.equal(got.isnan(), nan) and torch.equal(got[~nan],
                                                         want[~nan])


# ---------------------------------------------------------------------- #
# the kernel's source and its mirror agree on the classes and the networks
# ---------------------------------------------------------------------- #
def test_size_classes_match_the_launcher():
    listed = re.search(r"return launch_class<([\d,\s]+)>", CU).group(1)
    assert tuple(int(c) for c in listed.split(",")) == k2.SIZE_CLASSES
    assert k2.SIZE_CLASSES == tuple(sorted(k2.SIZE_CLASSES))
    assert k2.MAX_ROWS == 128 == k2.SIZE_CLASSES[-1]


def test_network_sizes_match_the_kernels_static_asserts():
    asserted = {int(c): int(size) for c, size in re.findall(
        r"static_assert\(Network<(\d+)>::kNet\.size == (\d+)", CU)}
    assert len(asserted) >= 4
    for c, size in asserted.items():
        assert sum(len(stage) for stage in k2.network(c)) == size, c
    assert int(re.search(r"kMaxComparators = (\d+)", CU).group(1)) == \
        sum(len(stage) for stage in k2.network(128))


@pytest.mark.parametrize("n", [0, -1, 129, 1000])
def test_size_class_raises_beyond_the_classes(n):
    with pytest.raises(ValueError):
        k2.size_class(n)


def test_size_class_is_the_smallest_class_at_least_n():
    for n in range(1, 129):
        c = k2.size_class(n)
        assert c >= n and c in k2.SIZE_CLASSES
        assert all(d < n for d in k2.SIZE_CLASSES if d < c)
    with pytest.raises(ValueError):
        k2.robust_aggregate_network(torch.ones(129, 4), 129)


@pytest.mark.parametrize("c", k2.SIZE_CLASSES)
def test_network_sorts_with_pads_on_top(c):
    """Every stage's comparators are disjoint and point upward, and the cut
    network sorts any n <= c real keys with ``PAD_KEY`` above them."""
    stages = k2.network(c)
    for stage in stages:
        wires = [w for ab in stage for w in ab]
        assert len(wires) == len(set(wires))
        assert all(a < b < c for a, b in stage)
    rng = np.random.default_rng(c)
    for n in sorted({1, max(1, c - 3), c // 2 + 1, c}):
        x = torch.from_numpy(rng.integers(-4, 5, (n, 64)).astype(np.float32))
        keys = k2.sort_keys(x, n)
        assert keys.shape == (k2.size_class(n), 64)
        assert bool((keys[1:] >= keys[:-1]).all())
        assert bool((keys[n:] == k2.PAD_KEY).all())
        assert torch.equal(k2.from_keys(keys[:n]),
                           torch.sort(x, dim=0).values)


# ---------------------------------------------------------------------- #
# the key map
# ---------------------------------------------------------------------- #
def test_keys_keep_the_floats_order_and_invert():
    ordered = np.array([-np.inf, -3.4e38, -1.0, -1e-38, -1e-45, -0.0, 0.0,
                        1e-45, 1e-38, 1.0, 3.4e38, np.inf], np.float32)
    t = torch.from_numpy(ordered)
    keys = k2.to_keys(t)
    assert bool((keys[1:] > keys[:-1]).all())
    assert bool((keys >= -(1 << 31)).all() and (keys < (1 << 31)).all())
    assert torch.equal(k2.from_keys(keys).view(torch.int32),
                       t.view(torch.int32))


def test_every_nan_keys_above_inf_and_decodes_to_nan():
    bits = np.array([0x7FC00000, 0x7F800001, 0x7FFFFFFF, 0xFFC00000,
                     0xFF800001, 0xFFFFFFFF], np.uint32)
    nans = torch.from_numpy(bits.view(np.float32))
    keys = k2.to_keys(nans)
    top = k2.to_keys(torch.tensor([np.inf], dtype=torch.float32))
    assert bool((keys > top).all()) and bool((keys <= k2.PAD_KEY).all())
    assert bool(k2.from_keys(keys).isnan().all())


# ---------------------------------------------------------------------- #
# the mirror against the plain version, every n, every trim
# ---------------------------------------------------------------------- #
# the host oracles add +-inf and +-3e38 in numpy, which warns
@pytest.mark.filterwarnings("ignore:overflow encountered:RuntimeWarning")
@pytest.mark.filterwarnings("ignore:invalid value encountered:RuntimeWarning")
@pytest.mark.parametrize("n", range(1, 129))
def test_network_bit_equal_to_plain_version(n):
    rows = min(128, n + 3)
    x = _column_inputs(n, rows, seed=n)
    for dtype in (torch.float32, torch.bfloat16):
        tx = torch.from_numpy(x).to(dtype)
        keys = k2.sort_keys(tx, n)
        for trim in range((n - 1) // 2 + 1):
            got = k2.reduce_keys(keys, n, trim, "trimmed_mean", dtype)
            want = k2.robust_aggregate_ref(tx, n, trim=trim)
            assert got.dtype == dtype and _same(got, want), (dtype, trim)
        got = k2.reduce_keys(keys, n, 0, "median", dtype)
        want = k2.robust_aggregate_ref(tx, n, mode="median")
        assert _same(got, want), dtype
        # the window of all -0 columns sums to -0, in both
        assert bool(torch.signbit(got[32:40]).all())
    # and the whole function against the host oracles (numpy's sort: every
    # NaN last, either sign)
    tx = torch.from_numpy(x)
    for port in (tdfs.TrimmedMean(0.2), tdfs.Median()):
        if isinstance(port, tdfs.TrimmedMean):
            got = k2.robust_aggregate_network(tx, n, trim=port.n_trim(n))
        else:
            got = k2.robust_aggregate_network(tx, n, mode="median")
        want = torch.from_numpy(port.aggregate_host(x[:n])[0])
        assert _same(got, want), port


@pytest.fixture(scope="module")
def pallas():
    import jax.numpy as jnp
    return reference("kernels.ops"), jnp


@pytest.mark.parametrize("mode", ["trimmed_mean", "median"])
@pytest.mark.parametrize("n,rows,m", [(5, 8, 300), (9, 16, 257),
                                      (13, 16, 700), (16, 16, 128)])
def test_network_matches_pallas_interpret(pallas, n, rows, m, mode):
    ops, jnp = pallas
    rng = np.random.default_rng(n * 1000 + m)
    x = np.zeros((rows, m), np.float32)
    x[:n] = rng.standard_normal((n, m))
    trim = tdfs.TrimmedMean(0.2).n_trim(n) if mode == "trimmed_mean" else 0
    got = k2.robust_aggregate_network(torch.from_numpy(x), n, trim=trim,
                                      mode=mode).numpy()
    want = np.asarray(ops.robust_aggregate(jnp.asarray(x), n, trim=trim,
                                           mode=mode))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------- #
# one-line wrong variants must fail
# ---------------------------------------------------------------------- #
def test_plain_sign_flip_for_nan_fails(monkeypatch):
    """Keys without the rotation: a NaN with its sign bit set sorts below
    -inf, so ranks shift and the NaN leaves the top."""
    n = 11
    x = _column_inputs(n, n, seed=5)
    x[:3, 0] = SIGN_NAN                     # trimmed away at b = 3
    tx = torch.from_numpy(x)
    want = k2.robust_aggregate_ref(tx, n, trim=3)
    assert _same(k2.robust_aggregate_network(tx, n, trim=3), want)

    def plain_flip(v):
        return k2._flip(v.contiguous().view(torch.int32).to(torch.int64))

    monkeypatch.setattr(k2, "to_keys", plain_flip)
    monkeypatch.setattr(k2, "from_keys", lambda key: k2._flip(key).to(
        torch.int32).view(torch.float32))
    assert not _same(k2.robust_aggregate_network(tx, n, trim=3), want)


def test_accumulator_from_plus_zero_fails(monkeypatch):
    """An all -0 rank window sums to -0 in the reference; from +0.0 the
    sum is +0 (equal as a value, wrong in its sign bit)."""
    n = 7
    x = np.full((n, 4), -0.0, np.float32)
    tx = torch.from_numpy(x)
    want = k2.robust_aggregate_ref(tx, n, trim=2)
    assert bool(torch.signbit(want).all())
    got = k2.robust_aggregate_network(tx, n, trim=2)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    monkeypatch.setattr(k2, "ACC_START", 0.0)
    bad = k2.robust_aggregate_network(tx, n, trim=2)
    assert not bool(torch.signbit(bad).any())


def test_wrapper_cpu_route_is_the_plain_version(monkeypatch):
    """On a CPU tensor the wrapper runs ``robust_aggregate_ref``, never the
    mirror, and launches nothing."""
    def no_mirror(*args, **kw):
        raise AssertionError("the wrapper called the kernel's mirror")

    monkeypatch.setattr(k2, "robust_aggregate_network", no_mirror)
    monkeypatch.setattr(k2, "sort_keys", no_mirror)
    x = torch.from_numpy(_column_inputs(9, 12, seed=9))
    before = k2.robust_aggregate.launches
    for kw in (dict(trim=2), dict(mode="median")):
        got = k2.robust_aggregate(x, 9, **kw)
        want = k2.robust_aggregate_ref(x, 9, **kw)
        assert _same(got, want) and torch.equal(
            got.view(torch.int32), want.view(torch.int32))
    assert k2.robust_aggregate.launches == before
