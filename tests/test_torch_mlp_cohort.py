"""Port parity of the data plane: the MLP (forward, masked loss, gradients,
epochs), the loop oracle's ``local_train`` and the vectorized cohort engine
(``cohort_train``/``cohort_eval``), each against the JAX package with the
reference's initial params injected through ``convert.py``; and, inside the
port, the padding contract bit for bit.

Tolerances: 1e-6 for one forward/backward (float32 products over a
784-long contraction, summed in another order), 1e-5 after an epoch of
SGD steps, and one test sample's worth of accuracy (1/U) where a
prediction sits on a decision boundary.
"""
import types

import numpy as np
import pytest
import torch
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data.partition import ClientData
from repro_torch.data.synthetic_mnist import Dataset
from repro_torch.federated import cohort
from repro_torch.federated.client import local_train
from repro_torch.federated.task import MnistTask
from repro_torch.models import mlp
from repro_torch.random import PRNGKey


@pytest.fixture(scope="module")
def ref():
    import jax
    import jax.numpy as jnp
    ns = types.SimpleNamespace(
        jax=jax, jnp=jnp, mlp=reference("models.mlp"),
        cohort=reference("federated.cohort"),
        client=reference("federated.client"),
        task=reference("federated.task"), pa=reference("data.partition"),
        sm=reference("data.synthetic_mnist"))
    ns.p0 = {k: np.asarray(v)
             for k, v in ns.mlp.mlp_init(jax.random.PRNGKey(0)).items()}
    return ns


def _data(n, seed, n_valid=None):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 784)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    m = np.zeros(n, np.float32)
    m[:n if n_valid is None else n_valid] = 1.0
    return x, y, m


def _close(got, want, atol):
    got = params_to_numpy(got)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == np.shape(want[k])
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=atol,
                                   rtol=0)


def test_mlp_apply_loss_and_grads(ref):
    x, y, m = _data(50, 0, n_valid=37)
    p = params_from_numpy(ref.p0, "cpu")
    jp = {k: ref.jnp.asarray(v) for k, v in ref.p0.items()}
    np.testing.assert_allclose(
        mlp.mlp_apply(p, torch.from_numpy(x)).numpy(),
        np.asarray(ref.mlp.mlp_apply(jp, ref.jnp.asarray(x))), atol=1e-6,
        rtol=0)
    batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y).long(),
             "m": torch.from_numpy(m)}
    jbatch = {k: ref.jnp.asarray(v) for k, v in
              {"x": x, "y": y, "m": m}.items()}
    loss = mlp.mlp_loss_masked(p, batch)
    assert loss.item() == pytest.approx(
        float(ref.mlp.mlp_loss_masked(jp, jbatch)), abs=1e-6)
    assert mlp.mlp_loss(p, batch).item() == pytest.approx(
        float(ref.mlp.mlp_loss(jp, jbatch)), abs=1e-6)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    grads = torch.autograd.grad(mlp.mlp_loss_masked(leaves, batch),
                                list(leaves.values()))
    jgrads = ref.jax.grad(ref.mlp.mlp_loss_masked)(jp, jbatch)
    _close(dict(zip(leaves, grads)), jgrads, atol=1e-6)
    assert mlp.mlp_accuracy_masked(
        p, batch["x"], batch["y"], batch["m"]).item() == pytest.approx(
        float(ref.mlp.mlp_accuracy_masked(jp, jbatch["x"], jbatch["y"],
                                          jbatch["m"])), abs=1e-7)


def test_one_epoch_masked_and_plain(ref):
    x, y, m = _data(200, 1, n_valid=150)
    p = params_from_numpy(ref.p0, "cpu")
    jp = {k: ref.jnp.asarray(v) for k, v in ref.p0.items()}
    tx, ty, tm = (torch.from_numpy(x), torch.from_numpy(y).long(),
                  torch.from_numpy(m))
    jx, jy, jm = ref.jnp.asarray(x), ref.jnp.asarray(y), ref.jnp.asarray(m)
    _close(mlp.mlp_sgd_epoch_masked(p, tx, ty, tm, 0.1, 50),
           ref.mlp.mlp_sgd_epoch_masked(jp, jx, jy, jm, 0.1, 50), atol=1e-5)
    _close(mlp.mlp_sgd_epoch(p, tx[:150], ty[:150], 0.1, 50),
           ref.mlp.mlp_sgd_epoch(jp, jx[:150], jy[:150], 0.1, 50),
           atol=1e-5)


def _cohort(seed=2, sizes=(150, 50, 100, 0), s=150):
    rng = np.random.default_rng(seed)
    n = len(sizes)
    x = np.zeros((n, s, 784), np.float32)
    y = np.zeros((n, s), np.int32)
    m = np.zeros((n, s), np.float32)
    for i, k in enumerate(sizes):
        x[i, :k] = rng.random((k, 784))
        y[i, :k] = rng.integers(0, 10, k)
        m[i, :k] = 1.0
    return x, y, m


def _port_cohort(x, y, m):
    return ({"x": torch.from_numpy(x), "y": torch.from_numpy(y).long()},
            torch.from_numpy(m))


def test_cohort_train_and_eval_match_reference(ref):
    x, y, m = _cohort()
    task, rtask = MnistTask(), ref.task.MnistTask()
    p = params_from_numpy(ref.p0, "cpu")
    jp = {k: ref.jnp.asarray(v) for k, v in ref.p0.items()}
    data, mask = _port_cohort(x, y, m)
    st, acc = cohort.cohort_train(task, p, data, mask, 0.1, 2, 50)
    jst, jacc = ref.cohort.cohort_train(
        rtask, jp, {"x": ref.jnp.asarray(x), "y": ref.jnp.asarray(y)},
        ref.jnp.asarray(m), 0.1, 2, 50)
    _close(st, jst, atol=1e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), atol=1 / 50)
    # the fully padded row is a strict no-op
    for k in st:
        assert torch.equal(st[k][3], p[k])
        assert torch.equal(cohort.unstack(st, 1)[k], st[k][1])
    assert acc[3].item() == 0.0
    merged = cohort.merge_stacks([st, cohort.pad_stacked(st, 6)],
                                 np.array([9, 0]))
    for k in st:
        assert torch.equal(merged[k][0], torch.zeros_like(st[k][0]))
        assert torch.equal(merged[k][1], st[k][0])

    _, test = ref.sm.generate(10, 400, seed=4)
    masks = np.stack([np.isin(test.y, [0, 1, 2]), np.isin(test.y, [5]),
                      np.ones_like(test.y, bool),
                      np.zeros_like(test.y, bool)]).astype(np.float32)
    got = cohort.cohort_eval(task, st, task.eval_inputs(test, "cpu"),
                             task.unit_targets(test, "cpu"),
                             torch.from_numpy(masks)).numpy()
    want = np.asarray(ref.cohort.cohort_eval(
        rtask, ref.jax.tree.map(ref.jnp.asarray, params_to_numpy(st)),
        rtask.eval_inputs(test), rtask.unit_targets(test),
        ref.jnp.asarray(masks)))
    np.testing.assert_allclose(got, want, atol=1 / masks[1].sum())
    assert got[3] == 0.0


def test_local_train_matches_reference(ref):
    x, y, _ = _data(150, 5)
    p = params_from_numpy(ref.p0, "cpu")
    jp = {k: ref.jnp.asarray(v) for k, v in ref.p0.items()}
    rep = local_train(ClientData(3, Dataset(x, y)), p, 2, 0.1, 50)
    rrep = ref.client.local_train(ref.pa.ClientData(3, ref.sm.Dataset(x, y)),
                                  jp, 2, 0.1, 50)
    _close(rep.params, rrep.params, atol=1e-5)
    assert rep.acc_local == pytest.approx(rrep.acc_local, abs=1 / 150)
    assert (rep.ue_id, rep.n_samples) == (rrep.ue_id, rrep.n_samples)


def test_padding_is_bit_exact_in_the_port():
    """Sample-axis padding (extra all-padding batches) and cohort-axis null
    rows leave every real client's result unchanged, bit for bit; a masked
    epoch on a padded client equals the plain epoch on its real rows."""
    task = MnistTask()
    p = mlp.mlp_init(PRNGKey(0, "cpu"), device="cpu")
    x, y, m = _cohort(seed=7, sizes=(100, 150, 50), s=150)
    st, acc = cohort.cohort_train(task, p, *_port_cohort(x, y, m), 0.1, 2,
                                  50)
    pad = lambda a: np.concatenate(
        [a, np.zeros((a.shape[0], 100) + a.shape[2:], a.dtype)], 1)
    st_s, acc_s = cohort.cohort_train(
        task, p, *_port_cohort(pad(x), pad(y), pad(m)), 0.1, 2, 50)
    null = lambda a: np.concatenate([a, np.zeros((5,) + a.shape[1:],
                                                 a.dtype)])
    st_n, acc_n = cohort.cohort_train(
        task, p, *_port_cohort(null(x), null(y), null(m)), 0.1, 2, 50)
    for k in st:
        assert torch.equal(st[k], st_s[k])
        assert torch.equal(st[k], st_n[k][:3])
        assert torch.equal(st_n[k][3:], p[k].expand_as(st_n[k][3:]))
    assert torch.equal(acc, acc_s) and torch.equal(acc, acc_n[:3])
    plain = mlp.mlp_sgd_epoch(p, torch.from_numpy(x[0, :100]),
                              torch.from_numpy(y[0, :100]).long(), 0.1, 50)
    masked = mlp.mlp_sgd_epoch_masked(
        p, torch.from_numpy(x[0]), torch.from_numpy(y[0]).long(),
        torch.from_numpy(m[0]), 0.1, 50)
    for k in p:
        assert torch.equal(plain[k], masked[k])


def test_mlp_init_layout_and_truncation():
    p = mlp.mlp_init(PRNGKey(1, "cpu"), device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w1": (784, 64), "b1": (64,), "w2": (64, 10), "b2": (10,)}
    assert all(v.dtype == torch.float32 for v in p.values())
    assert not p["b1"].any() and not p["b2"].any()
    for k, fan_in in (("w1", 784), ("w2", 64)):
        std = 1.0 / np.sqrt(fan_in)
        assert p[k].abs().max().item() <= 3 * std * (1 + 1e-6)
    # truncated N(0, 1) at +-3 has std 0.9866
    assert p["w1"].std().item() * np.sqrt(784) == pytest.approx(0.9866,
                                                                abs=0.01)
    q = mlp.mlp_init(PRNGKey(1, "cpu"), device="cpu")
    assert all(torch.equal(p[k], q[k]) for k in p)
    # pinned draw: the reference's mlp_init(PRNGKey(1)) weights, which the
    # threefry draw gives on every torch version and device (the main
    # path's CPU and GPU runs start from the reference's model)
    np.testing.assert_allclose(
        p["w1"][0, :3].numpy(), [0.018941371, -0.025738884, 0.032286264],
        rtol=1e-6)
    np.testing.assert_allclose(p["w2"][5, :2].numpy(),
                               [-0.069667928, -0.097630784], rtol=1e-6)


def test_masked_epoch_rejects_ragged_length():
    p = mlp.mlp_init(PRNGKey(0, "cpu"), device="cpu")
    x, y, m = _data(70, 0)
    with pytest.raises(ValueError):
        mlp.mlp_sgd_epoch_masked(p, torch.from_numpy(x),
                                 torch.from_numpy(y).long(),
                                 torch.from_numpy(m), 0.1, 50)
