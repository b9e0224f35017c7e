"""The slice end to end: the port's ``FeelServer`` (host control plane,
vectorized and loop engines) against the JAX package's on a K = 20
label-flip run, the reference's initial params injected.

Tolerances: selections and the host RNG stream are exact. ``global_acc``
is held within 1e-2 per round and reputations within 5e-2: on the
reference alone, a 1e-6 relative change to the initial params moves
``global_acc`` by up to 2e-3 and reputations by up to 1.7e-2 over 4 rounds
(K = 30) with the selections unchanged, and float32 products summed in
another order are such a change. Inside the port, the two engines must
agree as tests/test_cohort.py requires of the reference's.
"""
import dataclasses
import types

import numpy as np
import pytest
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.configs.base import FeelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.poisoning import (EASY_PAIR, LabelFlipAttack,
                                        pick_malicious)
from repro_torch.data.partition import partition
from repro_torch.data.synthetic_mnist import generate
from repro_torch.federated.server import FeelServer
from repro_torch.kernels.weighted_aggregate import weighted_aggregate


def _setup(mods, cfg, n_train, n_test, seed, flip=True):
    """(clients, test, rng) from one package's modules, the quickstart
    recipe: generate, pick the malicious set, partition with the flip."""
    rng = np.random.default_rng(seed)
    train, test = mods.sm.generate(n_train, n_test, seed=seed)
    mal = mods.po.pick_malicious(cfg.n_ues, cfg.n_malicious, rng)
    clients = mods.pa.partition(
        train, cfg.n_ues, rng, mal,
        mods.po.LabelFlipAttack(*mods.po.EASY_PAIR) if flip else None)
    return clients, test, rng


PORT = types.SimpleNamespace(
    sm=types.SimpleNamespace(generate=generate),
    po=types.SimpleNamespace(pick_malicious=pick_malicious,
                             LabelFlipAttack=LabelFlipAttack,
                             EASY_PAIR=EASY_PAIR),
    pa=types.SimpleNamespace(partition=partition))


def _ref_mods():
    return types.SimpleNamespace(sm=reference("data.synthetic_mnist"),
                                 po=reference("core.poisoning"),
                                 pa=reference("data.partition"),
                                 cfg=reference("configs.base"),
                                 srv=reference("federated.server"))


def _run_pair(cfg, n_train, n_test, seed, rounds, ref_kw=(), **kw):
    """Reference and port servers on the same seed; returns both servers,
    their logs and each host RNG's next draw after the rounds. ``kw`` goes
    to both servers, ``ref_kw`` to the reference's alone (it overrides)."""
    rm = _ref_mods()
    rcfg = rm.cfg.FeelConfig(**dataclasses.asdict(cfg))
    clients, test, rng = _setup(rm, rcfg, n_train, n_test, seed)
    ref_srv = rm.srv.FeelServer(rcfg, clients, test, rng, control="host",
                                **{**kw, **dict(ref_kw)})
    p0 = {k: np.asarray(v) for k, v in ref_srv.params.items()}
    ref_logs = ref_srv.run(rounds)
    ref_next = rng.integers(1 << 31)
    out = {"ref": (ref_logs, ref_next)}
    for engine in ("vectorized", "loop"):
        clients, test, rng = _setup(PORT, cfg, n_train, n_test, seed)
        srv = FeelServer(cfg, clients, test, rng, engine=engine,
                         device="cpu", **kw)
        srv.params = params_from_numpy(p0, "cpu")
        out[engine] = (srv.run(rounds), rng.integers(1 << 31), srv)
    out["ref_srv"] = ref_srv
    return out


@pytest.fixture(scope="module")
def slice_run():
    launches = weighted_aggregate.launches
    out = _run_pair(FeelConfig(n_ues=20, n_malicious=2), 6000, 1000, 0, 3)
    out["launches"] = weighted_aggregate.launches - launches
    return out


def test_selection_equal_every_round(slice_run):
    ref_logs, _ = slice_run["ref"]
    logs = slice_run["vectorized"][0]
    assert len(logs) == len(ref_logs) == 3
    for log, rl in zip(logs, ref_logs):
        np.testing.assert_array_equal(log.selected, rl.selected)
        assert log.n_malicious_selected == rl.n_malicious_selected
        assert log.forced == rl.forced
    assert logs[0].n_malicious_selected > 0       # the flip is in play


def test_accuracy_and_reputation_within_tolerance(slice_run):
    ref_logs, _ = slice_run["ref"]
    for log, rl in zip(slice_run["vectorized"][0], ref_logs):
        assert abs(log.global_acc - rl.global_acc) <= 1e-2
        np.testing.assert_allclose(log.reputations, rl.reputations,
                                   atol=5e-2)
        np.testing.assert_allclose(log.values, rl.values, atol=5e-2)
        assert log.objective == pytest.approx(rl.objective, abs=5e-2 * 20)
    accs = [l.global_acc for l in slice_run["vectorized"][0]]
    assert accs[-1] > accs[0]


def test_host_rng_stream_aligned(slice_run):
    _, ref_next = slice_run["ref"]
    assert slice_run["vectorized"][1] == ref_next
    assert slice_run["loop"][1] == ref_next
    srv, ref_srv = slice_run["vectorized"][2], slice_run["ref_srv"]
    np.testing.assert_array_equal(srv.cpu_hz, ref_srv.cpu_hz)
    np.testing.assert_array_equal(srv.wireless.distances,
                                  ref_srv.wireless.distances)
    np.testing.assert_array_equal(srv.pad_waste, ref_srv.pad_waste)


def test_loop_engine_matches_vectorized(slice_run):
    """As tests/test_cohort.py holds the reference's engines: the same
    schedules, accuracy curves within 1e-5, reputations within 1e-5."""
    vec, loop = slice_run["vectorized"][0], slice_run["loop"][0]
    for a, b in zip(vec, loop):
        np.testing.assert_array_equal(a.selected, b.selected)
        assert a.n_malicious_selected == b.n_malicious_selected
        assert abs(a.global_acc - b.global_acc) <= 1e-5
        np.testing.assert_allclose(a.reputations, b.reputations, atol=1e-5)


def test_cpu_run_launches_no_kernel(slice_run):
    assert slice_run["launches"] == 0


@pytest.mark.parametrize("policy,adaptive", [
    ("dqs", False), ("dqs", True), ("random", False),
    ("best_channel", False), ("max_count", False), ("top_value", False)])
def test_policies_select_as_reference(policy, adaptive):
    """Every policy through the whole server, on a K = 12 run: the same
    selections and the same host RNG stream (``random`` draws a
    permutation per round). A 2 kHz band makes the K-fraction budget bind,
    so the policies choose differently."""
    cfg = FeelConfig(n_ues=12, n_malicious=2, bandwidth_hz=2e3)
    out = _run_pair(cfg, 3000, 300, 1, 2, policy=policy,
                    adaptive_omega=adaptive)
    ref_logs, ref_next = out["ref"]
    for engine in ("vectorized", "loop"):
        logs, nxt, _ = out[engine]
        assert nxt == ref_next
        for log, rl in zip(logs, ref_logs):
            np.testing.assert_array_equal(log.selected, rl.selected)
            assert log.forced == rl.forced


def test_scheduled_flip_and_watch_pair_match_reference():
    """An intermittent label flip trains the malicious UEs on their clean
    twins in off rounds (twin-row gather, vectorized; clean data, loop),
    and the watched (6 -> 2) pair's metrics follow the reference's."""
    from repro_torch.core.attacks import AttackScenario, MaliciousSchedule
    rat = reference("core.attacks")
    cfg = FeelConfig(n_ues=12, n_malicious=3)
    out = _run_pair(
        cfg, 3000, 300, 2, 3,
        scenario=AttackScenario("flip_int2", watch=EASY_PAIR,
                                schedule=MaliciousSchedule("intermittent",
                                                           2, 1)),
        ref_kw=dict(scenario=rat.AttackScenario(
            "flip_int2", watch=EASY_PAIR,
            schedule=rat.MaliciousSchedule("intermittent", 2, 1))))
    ref_logs, ref_next = out["ref"]
    vec, loop = out["vectorized"][0], out["loop"][0]
    assert out["vectorized"][1] == out["loop"][1] == ref_next
    for log, lp, rl in zip(vec, loop, ref_logs):
        np.testing.assert_array_equal(log.selected, rl.selected)
        for f in ("global_acc", "source_acc", "attack_success"):
            assert abs(getattr(log, f) - getattr(rl, f)) <= 1e-2, f
            assert abs(getattr(log, f) - getattr(lp, f)) <= 1e-5, f
        assert np.isfinite(log.source_acc) and np.isfinite(log.rep_gap)
        assert abs(log.rep_gap - rl.rep_gap) <= 5e-2


@pytest.mark.parametrize("kw,err", [
    (dict(control="jax"), ValueError),
    (dict(defense="no_such_defense"), KeyError),
    (dict(task="no_such_task"), KeyError),
    (dict(engine="sharded"), ValueError),
    (dict(policy="oracle"), KeyError),
])
def test_server_rejects_what_the_slice_does_not_run(kw, err):
    cfg = FeelConfig(n_ues=4, n_malicious=0)
    clients, test, rng = _setup(PORT, cfg, 800, 100, 0, flip=False)
    with pytest.raises(err):
        FeelServer(cfg, clients, test, rng, device="cpu", **kw)


def test_vectorized_engine_requires_dividing_batch_size():
    cfg = FeelConfig(n_ues=4, n_malicious=0)
    clients, test, rng = _setup(PORT, cfg, 800, 100, 0, flip=False)
    srv = FeelServer(cfg, clients, test, rng, device="cpu", batch_size=40)
    with pytest.raises(ValueError):
        srv.run_round(0)
