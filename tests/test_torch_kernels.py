"""Port parity of the FedAvg kernel K1 (``weighted_aggregate``): its plain
PyTorch version — what the wrapper runs on a CPU tensor — against the
Pallas TPU kernel (interpret mode, as tests/test_kernels.py runs it) and
``repro.kernels.ref.weighted_aggregate_ref``. The CUDA kernel itself runs
only on the card; ``chip_smoke.py`` holds it against the plain version
there.

Tolerances: atol = rtol = 1e-6 for float32 (the two sides accumulate the
same rows in the same order, but XLA may contract to FMA) and 1e-2 for
bfloat16 (one output rounding to 8 mantissa bits).
"""
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.federated import aggregation as tag
from repro_torch.kernels.weighted_aggregate import (weighted_aggregate,
                                                    weighted_aggregate_ref)

TOL = {"float32": 1e-6, "bfloat16": 1e-2}


@pytest.fixture(scope="module")
def ref():
    import jax.numpy as jnp
    return types.SimpleNamespace(ops=reference("kernels.ops"),
                                 kref=reference("kernels.ref"),
                                 agg=reference("federated.aggregation"),
                                 jnp=jnp)


def _inputs(n, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, m)).astype(np.float32)
    w = (np.abs(rng.standard_normal(n)) + 1e-3).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,m", [(1, 1), (1, 4097), (3, 5), (7, 4097),
                                 (8, 50_890), (32, 50_890), (56, 50_890),
                                 (64, 2051)])
def test_plain_matches_pallas_and_ref(ref, n, m, dtype):
    x, w = _inputs(n, m, seed=n * 7919 + m)
    jx = ref.jnp.asarray(x).astype(getattr(ref.jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = weighted_aggregate(tx, torch.from_numpy(w)).float().numpy()
    pallas = np.asarray(ref.ops.weighted_aggregate(jx, ref.jnp.asarray(w)),
                        np.float32)
    oracle = np.asarray(ref.kref.weighted_aggregate_ref(
        jx, ref.jnp.asarray(w)), np.float32)
    assert got.shape == (m,)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, oracle, atol=tol, rtol=tol)


@pytest.mark.parametrize("n,m", [(5, 300), (32, 50_890)])
def test_assume_normalized_matches_pallas(ref, n, m):
    """Pre-normalised weights are used as given (the caller's f64
    normalisation and single f32 rounding are kept)."""
    x, w = _inputs(n, m, seed=1)
    wn = (w.astype(np.float64) / w.sum()).astype(np.float32)
    got = weighted_aggregate(torch.from_numpy(x), torch.from_numpy(wn),
                             assume_normalized=True).numpy()
    want = np.asarray(ref.ops.weighted_aggregate(
        ref.jnp.asarray(x), ref.jnp.asarray(wn), assume_normalized=True))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # raw weights under assume_normalized are NOT renormalised
    raw = weighted_aggregate(torch.from_numpy(x), torch.from_numpy(w),
                             assume_normalized=True).numpy()
    np.testing.assert_allclose(raw, (w[:, None] * x).sum(0), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("seed", range(6))
def test_convex_envelope(seed):
    """A convex combination stays within the per-coordinate envelope of the
    rows (property of test_kernels.py's FedAvg test)."""
    rng = np.random.default_rng(seed)
    n, m = int(rng.integers(1, 65)), int(rng.integers(1, 5000))
    x, w = _inputs(n, m, seed)
    out = weighted_aggregate(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.all(out <= torch.from_numpy(x.max(0)) + 1e-5)
    assert torch.all(out >= torch.from_numpy(x.min(0)) - 1e-5)


def test_cpu_tensor_runs_plain_version_without_launch():
    x, w = _inputs(8, 1000, seed=3)
    before = weighted_aggregate.launches
    got = weighted_aggregate(torch.from_numpy(x), torch.from_numpy(w))
    assert weighted_aggregate.launches == before
    want = weighted_aggregate_ref(torch.from_numpy(x), torch.from_numpy(w))
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["3d", "int", "weights_shape",
                                  "noncontig", "empty"])
def test_wrapper_rejects_bad_inputs(case):
    x, w = torch.ones(4, 6), torch.ones(4)
    bad = {"3d": (torch.ones(2, 2, 3), torch.ones(2)),
           "int": (torch.ones(4, 6, dtype=torch.int32), w),
           "weights_shape": (x, torch.ones(5)),
           "noncontig": (torch.ones(6, 4).t(), w),
           "empty": (torch.ones(4, 0), w)}[case]
    with pytest.raises((ValueError, TypeError)):
        weighted_aggregate(*bad)


def _stacked(n, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w1": (784, 64), "b1": (64,), "w2": (64, 10), "b2": (10,)}
    return {k: rng.standard_normal((n,) + s).astype(np.float32)
            for k, s in shapes.items()}


def test_flatten_matches_reference_column_order(ref):
    """The flat (N, M) matrix equals the JAX package's, column for column
    (leaves in ``jax.tree.flatten`` order: b1, b2, w1, w2)."""
    import jax
    st = _stacked(5)
    flat = tag.flatten_stacked({k: torch.from_numpy(v)
                                for k, v in st.items()}).numpy()
    leaves = jax.tree.leaves({k: ref.jnp.asarray(v) for k, v in st.items()})
    want = np.concatenate([np.asarray(l).reshape(5, -1) for l in leaves], 1)
    assert flat.shape == (5, 50_890)
    np.testing.assert_array_equal(flat, want)


@pytest.mark.parametrize("kernel", [True, False])
def test_fedavg_stacked_matches_reference(ref, kernel):
    st = _stacked(6, seed=2)
    weights = np.array([300.0, 50.0, 1500.0, 0.0, 700.0, 0.0])
    got = tag.fedavg_stacked({k: torch.from_numpy(v) for k, v in st.items()},
                             weights)
    want = ref.agg.fedavg_stacked({k: ref.jnp.asarray(v)
                                   for k, v in st.items()}, weights,
                                  kernel=kernel)
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-6, rtol=1e-6)


def test_normalize_weights_and_list_form(ref):
    weights = [3.0, 1.0, 0.0, 7.5]
    np.testing.assert_array_equal(
        tag.normalize_weights(weights, "cpu").numpy(),
        np.asarray(ref.agg.normalize_weights(weights)))
    with pytest.raises(ValueError):
        tag.normalize_weights([0.0, 0.0], "cpu")
    st = {k: torch.from_numpy(v) for k, v in _stacked(4, seed=5).items()}
    listed = [{k: v[i] for k, v in st.items()} for i in range(4)]
    a, b = tag.fedavg(listed, weights), tag.fedavg_stacked(st, weights)
    for k in a:
        assert torch.equal(a[k], b[k])


# ---------------------------------------------------------------------- #
# K2 ``robust_aggregate``: the plain version against the Pallas kernel
# (interpret mode) and ``repro.kernels.ref.robust_aggregate_ref`` within
# atol = rtol = 1e-6 (the reference sums the kept ranks with a tree, the
# port sequentially), and bit-equal to the host oracles of the defense
# plane, which sum in the port's order. The main path's shape is in
# tests/test_torch_kernels_k2_main.py (its interpret compile is ~25 s).
# ---------------------------------------------------------------------- #
def _robust_inputs(n, n_pad, m, seed):
    rng = np.random.default_rng(seed)
    x = np.zeros((n_pad, m), np.float32)
    x[:n] = rng.normal(size=(n, m)).astype(np.float32)
    return x


def robust_case(ref, n, n_pad, m, mode, dtype="float32"):
    """(plain, Pallas, JAX ref, real rows) at one shape, as float32 numpy;
    the trim is the defense plane's n_trim(n) at 20%."""
    from repro_torch.core.defenses import TrimmedMean
    from repro_torch.kernels.robust_aggregate import robust_aggregate
    x = _robust_inputs(n, n_pad, m, seed=n * 1000 + m)
    trim = TrimmedMean(0.2).n_trim(n) if mode == "trimmed_mean" else 0
    jx = ref.jnp.asarray(x).astype(getattr(ref.jnp, dtype))
    got = robust_aggregate(torch.from_numpy(x).to(getattr(torch, dtype)), n,
                           trim=trim, mode=mode).float().numpy()
    pallas = np.asarray(ref.ops.robust_aggregate(jx, n, trim=trim,
                                                 mode=mode), np.float32)
    oracle = np.asarray(ref.kref.robust_aggregate_ref(jx, n, trim=trim,
                                                      mode=mode), np.float32)
    return got, pallas, oracle, x[:n]


@pytest.mark.parametrize("mode", ["trimmed_mean", "median"])
@pytest.mark.parametrize("n,n_pad,m", [(5, 8, 300), (8, 8, 2048),
                                       (13, 16, 700)])
def test_robust_plain_matches_pallas_and_ref(ref, n, n_pad, m, mode):
    got, pallas, oracle, real = robust_case(ref, n, n_pad, m, mode)
    assert got.shape == (m,)
    np.testing.assert_allclose(got, pallas, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got, oracle, atol=1e-6, rtol=1e-6)
    # a rank-window statistic stays within the real rows
    assert np.all(got <= real.max(0)) and np.all(got >= real.min(0))


@pytest.mark.parametrize("mode", ["trimmed_mean", "median"])
def test_robust_plain_bf16_matches_ref(ref, mode):
    """bf16 in, f32 math, one rounding on the way out: the same bits as the
    reference's ref twin, which computes in f32 and casts once too."""
    got, _, oracle, _ = robust_case(ref, 13, 16, 700, mode, "bfloat16")
    np.testing.assert_allclose(got, oracle, atol=1e-2, rtol=1e-2)


@pytest.fixture(scope="module")
def ref_defenses():
    return reference("core.defenses")


@pytest.mark.parametrize("n,n_pad", [(1, 1), (2, 8), (5, 8), (9, 16),
                                     (11, 16), (16, 16), (44, 48)])
def test_robust_plain_bit_equal_to_host_oracles(ref_defenses, n, n_pad):
    """The plain version is bit-equal to the port's and the reference's
    ``TrimmedMean/Median.aggregate_host`` (the same ascending sequential
    sum and single division; the median is exact everywhere)."""
    from repro_torch.core import defenses as tdfs
    from repro_torch.kernels.robust_aggregate import robust_aggregate
    x = _robust_inputs(n, n_pad, 257, seed=n)
    tx = torch.from_numpy(x)
    for port, refa in ((tdfs.TrimmedMean(0.2), ref_defenses.TrimmedMean(0.2)),
                       (tdfs.Median(), ref_defenses.Median())):
        if isinstance(port, tdfs.TrimmedMean):
            got = robust_aggregate(tx, n, trim=port.n_trim(n)).numpy()
        else:
            got = robust_aggregate(tx, n, mode="median").numpy()
        np.testing.assert_array_equal(got, port.aggregate_host(x[:n])[0])
        np.testing.assert_array_equal(got, refa.aggregate_host(x[:n])[0])


@pytest.mark.parametrize("n,n_pad", [(11, 16), (16, 16)])
def test_robust_plain_orders_nan_last_like_host_oracles(ref_defenses, n,
                                                        n_pad):
    """NaN uploads sort after every number over the n real rows, as numpy
    and the kernel order them: a column with more than b NaNs aggregates to
    NaN, one with fewer trims them away — the padding rows never enter."""
    from repro_torch.core import defenses as tdfs
    from repro_torch.kernels.robust_aggregate import robust_aggregate
    x = _robust_inputs(n, n_pad, 64, seed=n + 7)
    x[:n // 2 + 1, :8] = np.nan            # past every trim and the median
    x[0, 8:16] = np.nan                    # trimmed away
    x[n - 1, 16:24] = np.inf
    tx = torch.from_numpy(x)
    for port, refa in ((tdfs.TrimmedMean(0.2), ref_defenses.TrimmedMean(0.2)),
                       (tdfs.Median(), ref_defenses.Median())):
        if isinstance(port, tdfs.TrimmedMean):
            got = robust_aggregate(tx, n, trim=port.n_trim(n)).numpy()
        else:
            got = robust_aggregate(tx, n, mode="median").numpy()
        assert np.isnan(got[:8]).all() and np.isfinite(got[8:]).all()
        np.testing.assert_array_equal(got, port.aggregate_host(x[:n])[0])
        np.testing.assert_array_equal(got, refa.aggregate_host(x[:n])[0])


def test_robust_cpu_tensor_runs_plain_version_without_launch():
    from repro_torch.kernels.robust_aggregate import (robust_aggregate,
                                                      robust_aggregate_ref)
    x = torch.from_numpy(_robust_inputs(7, 8, 1000, seed=3))
    before = robust_aggregate.launches
    for mode, trim in (("trimmed_mean", 2), ("median", 0)):
        got = robust_aggregate(x, 7, trim=trim, mode=mode)
        assert torch.equal(got, robust_aggregate_ref(x, 7, trim=trim,
                                                     mode=mode))
    assert robust_aggregate.launches == before


@pytest.mark.parametrize("case", ["3d", "int", "noncontig", "empty",
                                  "n_zero", "n_over", "trim_half",
                                  "trim_neg", "rows_over", "mode"])
def test_robust_wrapper_rejects_bad_inputs(case):
    from repro_torch.kernels.robust_aggregate import robust_aggregate
    x = torch.ones(8, 6)
    args, kw = {
        "3d": ((torch.ones(2, 2, 3), 2), {}),
        "int": ((torch.ones(8, 6, dtype=torch.int32), 4), {}),
        "noncontig": ((torch.ones(6, 8).t(), 4), {}),
        "empty": ((torch.ones(8, 0), 4), {}),
        "n_zero": ((x, 0), {}),
        "n_over": ((x, 9), {}),
        "trim_half": ((x, 6), {"trim": 3}),
        "trim_neg": ((x, 6), {"trim": -1}),
        "rows_over": ((torch.ones(129, 6), 100), {}),
        "mode": ((x, 4), {"mode": "mean"}),
    }[case]
    with pytest.raises((ValueError, TypeError)):
        robust_aggregate(*args, **kw)
