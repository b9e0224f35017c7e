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
        tag.normalize_weights(weights).numpy(),
        np.asarray(ref.agg.normalize_weights(weights)))
    with pytest.raises(ValueError):
        tag.normalize_weights([0.0, 0.0])
    st = {k: torch.from_numpy(v) for k, v in _stacked(4, seed=5).items()}
    listed = [{k: v[i] for k, v in st.items()} for i in range(4)]
    a, b = tag.fedavg(listed, weights), tag.fedavg_stacked(st, weights)
    for k in a:
        assert torch.equal(a[k], b[k])
