"""Port parity: synthetic MNIST, the non-IID partition with its label flip,
and the padding/bucketing helpers are byte-equal to the JAX package's and
consume the host RNG identically."""
import importlib
import types

import numpy as np
import pytest
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.core import poisoning as tpo
from repro_torch.data import synthetic_mnist as tsm

# the module: the package's ``partition`` is the partition function, the
# reference's public name
tpa = importlib.import_module("repro_torch.data.partition")


@pytest.fixture(scope="module")
def ref():
    return types.SimpleNamespace(sm=reference("data.synthetic_mnist"),
                                 pa=reference("data.partition"),
                                 po=reference("core.poisoning"))


def _same_array(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 5])
def test_generate_byte_equal(ref, seed):
    for got, want in zip(tsm.generate(700, 300, seed=seed),
                         ref.sm.generate(700, 300, seed=seed)):
        _same_array(got.x, want.x)
        _same_array(got.y, want.y)


def _partitions(ref, k, flip_fraction, n_mal=3, seed=1):
    train, _ = tsm.generate(3000, 10, seed=seed)
    out = []
    for po, pa in ((tpo, tpa), (ref.po, ref.pa)):
        rng = np.random.default_rng(seed)
        mal = po.pick_malicious(k, n_mal, rng)
        clients = pa.partition(train, k, rng, mal,
                               po.LabelFlipAttack(*po.EASY_PAIR,
                                                  flip_fraction))
        out.append((mal, clients, rng.integers(1 << 31)))
    return out


@pytest.mark.parametrize("k,flip_fraction", [(7, 1.0), (20, 1.0),
                                             (20, 0.5)])
def test_partition_byte_equal(ref, k, flip_fraction):
    (mal, got, nxt), (mal_r, want, nxt_r) = _partitions(ref, k,
                                                        flip_fraction)
    np.testing.assert_array_equal(mal, mal_r)
    assert nxt == nxt_r                     # same draws consumed
    assert len(got) == len(want) == k
    for g, w in zip(got, want):
        assert (g.ue_id, g.malicious, g.size) == (w.ue_id, w.malicious,
                                                  w.size)
        _same_array(g.data.x, w.data.x)
        _same_array(g.data.y, w.data.y)
        assert (g.clean is None) == (w.clean is None)
        if g.clean is not None:
            _same_array(g.clean.y, w.clean.y)
            assert not np.array_equal(g.clean.y, g.data.y) or \
                not (g.clean.y == tpo.EASY_PAIR[0]).any()
    assert any(c.malicious for c in got)


def test_padding_helpers_byte_equal(ref):
    (_, clients, _), (_, clients_r, _) = _partitions(ref, 12, 1.0)
    for kw in (dict(multiple_of=50), dict(multiple_of=50, pad_to=1500),
               dict(multiple_of=1)):
        got, want = tpa.pad_clients(clients, **kw), \
            ref.pa.pad_clients(clients_r, **kw)
        _same_array(got.mask, want.mask)
        _same_array(got.sizes, want.sizes)
        assert sorted(got.arrays) == sorted(want.arrays)
        for f in got.arrays:
            _same_array(got.arrays[f], want.arrays[f])
    for n_buckets in (1, 3):
        got = tpa.pad_clients_bucketed(clients, n_buckets=n_buckets,
                                       multiple_of=50)
        want = ref.pa.pad_clients_bucketed(clients_r, n_buckets=n_buckets,
                                           multiple_of=50)
        assert len(got) == len(want)
        for (ids, pd), (ids_r, pd_r) in zip(got, want):
            _same_array(ids, ids_r)
            _same_array(pd.x, pd_r.x)
            _same_array(pd.y, pd_r.y)
            _same_array(pd.mask, pd_r.mask)
    for args in ((1500, 3, 50), (1451, 3, 50), (7, 2, 1), (300, 1, 50)):
        _same_array(tpa.bucket_levels(*args), ref.pa.bucket_levels(*args))
    levels = tpa.bucket_levels(1500, 3, 50)
    sizes = np.array([50, 500, 501, 1000, 1500])
    _same_array(tpa.assign_buckets(sizes, levels),
                ref.pa.assign_buckets(sizes, levels))
    for c, cr in zip(clients, clients_r):
        _same_array(tpa.label_histogram(c.data),
                    ref.pa.label_histogram(cr.data))
        got, want = tpa.sample_arrays(c.data), ref.pa.sample_arrays(cr.data)
        assert sorted(got) == sorted(want)


def test_partition_rejects_scenario_data_attack():
    """A ``core.attacks`` data attack that does not fit the dataset (a
    token-space attack on feature data) raises, naming the context."""
    train, _ = tsm.generate(500, 10, seed=0)
    rng = np.random.default_rng(0)
    with pytest.raises(TypeError, match="task=mnist_mlp, scenario=tok"):
        tpa.partition(train, 4, rng, np.array([0]),
                      types.SimpleNamespace(poison_tokens=lambda *a: None),
                      context="task=mnist_mlp, scenario=tok")


def test_pad_clients_rejects_short_pad_to():
    train, _ = tsm.generate(1000, 10, seed=0)
    clients = tpa.partition(train, 3, np.random.default_rng(0))
    with pytest.raises(ValueError):
        tpa.pad_clients(clients, pad_to=max(c.size for c in clients) - 1)
