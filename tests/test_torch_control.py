"""Port parity of the host control plane, all exact in float64: channel
draws (memoryless and AR(1)), the Eq. 9 cost (bisection == scan ==
reference), Eq. 1/2/3, every scheduling policy including the dqs
modified-greedy fallback, and a forced (all-infeasible) round. Also the
relevant property cases of test_wireless.py, test_quality.py and
test_scheduler.py, run on the port."""
import dataclasses
import types

import numpy as np
import pytest
from torch_parity import reference, single_threaded  # noqa: F401

from repro_torch.configs.base import FeelConfig, dbm_to_watt
from repro_torch.core import attacks as tat
from repro_torch.core import diversity as tdi
from repro_torch.core import quality as tqu
from repro_torch.core import reputation as tre
from repro_torch.core import scheduler as tsc
from repro_torch.core.wireless import WirelessModel


@pytest.fixture(scope="module")
def ref():
    return types.SimpleNamespace(
        cfg=reference("configs.base"), wl=reference("core.wireless"),
        di=reference("core.diversity"), qu=reference("core.quality"),
        re=reference("core.reputation"), sc=reference("core.scheduler"),
        at=reference("core.attacks"))


def _ref_cfg(ref, cfg):
    return ref.cfg.FeelConfig(**dataclasses.asdict(cfg))


# ---------------------------------------------------------------------- #
# Wireless model (Eq. 4-7, 9)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("rho", [0.0, 0.4])
def test_channel_draws_exact(ref, rho):
    cfg = FeelConfig(n_ues=30, channel_corr=rho)
    rng, rng_r = np.random.default_rng(3), np.random.default_rng(3)
    wm, wm_r = WirelessModel(cfg, rng), ref.wl.WirelessModel(
        _ref_cfg(ref, cfg), rng_r)
    np.testing.assert_array_equal(wm.distances, wm_r.distances)
    for _ in range(4):
        np.testing.assert_array_equal(wm.draw_channels().gains,
                                      wm_r.draw_channels().gains)
    np.testing.assert_array_equal(wm.last_gains, wm_r.last_gains)
    assert rng.integers(1 << 31) == rng_r.integers(1 << 31)


def _cost_instance(seed, k, wireless):
    """Random gains/deadlines with the Eq. 9 edges forced in (blown and
    near-blown deadlines, one excellent channel) — test_wireless.py's
    instance generator."""
    cfg = FeelConfig(n_ues=k)
    rng = np.random.default_rng(seed)
    wm = wireless(cfg, rng)
    gains = wm.draw_channels().gains
    sizes = rng.integers(1, 31, k) * 50.0
    cpu = rng.uniform(cfg.cpu_hz_min, cfg.cpu_hz_max, k)
    tt = wm.train_time(sizes, cpu)
    tt[0] = cfg.deadline_s
    tt[1] = cfg.deadline_s + 1.0
    tt[2] = cfg.deadline_s * (1 - 1e-6)
    gains[3] = gains.max() * 1e3
    return cfg, wm, gains, tt, sizes, cpu


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("k", [7, 23, 50, 211])
def test_cost_exact(ref, seed, k):
    cfg, wm, gains, tt, sizes, cpu = _cost_instance(seed, k, WirelessModel)
    wm_r = ref.wl.WirelessModel(_ref_cfg(ref, cfg),
                                np.random.default_rng(seed))
    cost = wm.cost(gains, tt)
    np.testing.assert_array_equal(cost, wm.cost_scan(gains, tt))
    np.testing.assert_array_equal(cost, wm_r.cost(gains, tt))
    np.testing.assert_array_equal(wm.cost_scan(gains, tt),
                                  wm_r.cost_scan(gains, tt))
    assert cost[0] == k + 1 and cost[1] == k + 1
    np.testing.assert_array_equal(wm.train_time(sizes, cpu),
                                  wm_r.train_time(sizes, cpu))
    np.testing.assert_array_equal(wm.min_rate(tt), wm_r.min_rate(tt))
    alpha = np.where(cost <= k, cost / k, 0.0)
    np.testing.assert_array_equal(wm.rate(gains, alpha),
                                  wm_r.rate(gains, alpha))
    np.testing.assert_array_equal(wm.upload_time(gains, alpha),
                                  wm_r.upload_time(gains, alpha))


@pytest.mark.parametrize("seed", range(6))
def test_cost_is_minimal(seed):
    """Eq. 9: c_k is the MINIMUM feasible fraction count."""
    cfg = FeelConfig()
    wm = WirelessModel(cfg, np.random.default_rng(seed))
    gains = wm.draw_channels().gains
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 31, cfg.n_ues) * 50.0
    cpu = rng.uniform(cfg.cpu_hz_min, cfg.cpu_hz_max, cfg.n_ues)
    tt = wm.train_time(sizes, cpu)
    costs, r_min, K = wm.cost(gains, tt), wm.min_rate(tt), cfg.n_ues
    for k in range(K):
        c = costs[k]
        if c <= K:
            assert wm.rate(gains[k:k + 1], np.array([c / K]))[0] >= r_min[k]
            if c > 1:
                assert wm.rate(gains[k:k + 1],
                               np.array([(c - 1) / K]))[0] < r_min[k]
        else:
            assert wm.rate(gains[k:k + 1], np.array([1.0]))[0] < r_min[k]


def test_deadline_violation_infeasible_and_dbm():
    cfg = FeelConfig()
    wm = WirelessModel(cfg, np.random.default_rng(0))
    tt = np.full(cfg.n_ues, cfg.deadline_s + 1.0)
    assert np.all(wm.cost(wm.draw_channels().gains, tt) == cfg.n_ues + 1)
    assert dbm_to_watt(0) == pytest.approx(1e-3)
    assert dbm_to_watt(30) == pytest.approx(1.0)


def test_channel_corr_stationary_stats():
    """|h|^2 stays Exp(1) (mean 1) and its lag-1 correlation is ~rho^2."""
    rho = 0.8
    cfg = FeelConfig(n_ues=200, channel_corr=rho)
    wm = WirelessModel(cfg, np.random.default_rng(11))
    d_alpha = wm.distances ** cfg.pathloss_exp
    h2 = np.stack([wm.draw_channels().gains * d_alpha for _ in range(400)])
    assert abs(h2.mean() - 1.0) < 0.05
    corr = np.corrcoef(h2[:-1].ravel(), h2[1:].ravel())[0, 1]
    assert abs(corr - rho ** 2) < 0.05


# ---------------------------------------------------------------------- #
# Eq. 1 / 2 / 3
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quality_metrics_exact(ref, seed):
    rng = np.random.default_rng(seed)
    k = 25
    for labels in (rng.integers(0, 10, 300), np.zeros(40, int),
                   np.array([], int)):
        assert tdi.gini_simpson(labels, 10) == ref.di.gini_simpson(labels,
                                                                   10)
    divs = rng.uniform(0, 0.9, k)
    sizes = rng.integers(1, 31, k) * 50.0
    ages = rng.integers(1, 5, k).astype(float)
    gamma = (1 / 3, 1 / 3, 1 / 3)
    for args in ((divs, sizes, ages), (divs, np.full(k, 50.0), ages)):
        np.testing.assert_array_equal(tdi.diversity_index(*args, gamma),
                                      ref.di.diversity_index(*args, gamma))
    cfg = FeelConfig(n_ues=k)
    cfg_r = _ref_cfg(ref, cfg)
    tr, tr_r = tre.ReputationTracker(cfg), ref.re.ReputationTracker(cfg_r)
    for _ in range(4):
        sel = np.sort(rng.choice(k, 9, replace=False))
        acc_local = rng.uniform(0.2, 1.0, 9)
        acc_test = rng.uniform(0.0, 1.0, 9)
        np.testing.assert_array_equal(tr.update(sel, acc_local, acc_test),
                                      tr_r.update(sel, acc_local, acc_test))
    I = tdi.diversity_index(divs, sizes, ages, gamma)
    for t in (0, 7, 14):
        omega = tqu.adaptive_weights(t, 15, cfg)
        assert omega == ref.qu.adaptive_weights(t, 15, cfg_r)
        np.testing.assert_array_equal(
            tqu.data_quality_value(tr.values, I, cfg, omega=omega),
            ref.qu.data_quality_value(tr.values, I, cfg_r, omega=omega))
    np.testing.assert_array_equal(
        tqu.data_quality_value(tr.values, I, cfg),
        ref.qu.data_quality_value(tr.values, I, cfg_r))


def test_reputation_drops_for_liar_and_clips():
    rt = tre.ReputationTracker(FeelConfig(n_ues=3))
    rt.update(np.array([0, 1, 2]), np.array([0.6, 0.9, 0.6]),
              np.array([0.6, 0.5, 0.6]))
    assert rt.values[1] < rt.values[0] == rt.values[2]
    rt = tre.ReputationTracker(FeelConfig(n_ues=1))
    for _ in range(50):
        rt.update(np.array([0]), np.array([1.0]), np.array([0.0]))
    assert rt.values[0] == 0.0


def test_attack_schedule_and_reputation_gap_exact(ref):
    mal = np.array([False, True, True, False, True])
    rank = np.array([-1, 0, 1, -1, 2])
    for kind, period, duty in (("always", 1, 1), ("intermittent", 3, 2),
                               ("roundrobin", 2, 2)):
        s = tat.MaliciousSchedule(kind, period, duty)
        s_r = ref.at.MaliciousSchedule(kind, period, duty)
        for t in range(4):
            np.testing.assert_array_equal(s.active(t, mal, rank),
                                          s_r.active(t, mal, rank))
    reps = np.array([0.9, 0.2, 0.4, 0.8, 0.1])
    assert tat.reputation_gap(reps, mal) == ref.at.reputation_gap(reps, mal)
    assert np.isnan(tat.reputation_gap(reps, np.zeros(5, bool)))
    with pytest.raises(ValueError):
        tat.MaliciousSchedule("weekly")


# ---------------------------------------------------------------------- #
# Scheduling policies (Alg. 2 and the baselines)
# ---------------------------------------------------------------------- #
def _same_schedule(s, s_r):
    for f in ("x", "alpha", "cost", "value"):
        np.testing.assert_array_equal(getattr(s, f), getattr(s_r, f))
    assert s.objective() == s_r.objective()


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_policies_exact(ref, seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(5, 40))
    values = rng.uniform(0, 2, k)
    costs = rng.integers(1, k + 2, k)          # k+1 == infeasible
    gains = rng.uniform(1e-12, 1e-8, k)
    cfg = FeelConfig(n_ues=k)
    cfg_r = _ref_cfg(ref, cfg)
    _same_schedule(tsc.dqs_schedule(values, costs, cfg),
                   ref.sc.dqs_schedule(values, costs, cfg_r))
    _same_schedule(tsc.best_channel_schedule(values, costs, cfg, gains),
                   ref.sc.best_channel_schedule(values, costs, cfg_r, gains))
    _same_schedule(tsc.max_count_schedule(values, costs, cfg),
                   ref.sc.max_count_schedule(values, costs, cfg_r))
    _same_schedule(tsc.top_value_schedule(values, costs, cfg, 5),
                   ref.sc.top_value_schedule(values, costs, cfg_r, 5))
    r, r_r = np.random.default_rng(seed), np.random.default_rng(seed)
    _same_schedule(tsc.random_schedule(values, costs, cfg, r),
                   ref.sc.random_schedule(values, costs, cfg_r, r_r))
    assert r.integers(1 << 31) == r_r.integers(1 << 31)
    for policy in ("dqs", "max_count"):
        np.testing.assert_array_equal(
            tsc.priority_key(policy, values, costs, k),
            ref.sc.priority_key(policy, values, costs, k))


@pytest.mark.parametrize("seed", range(8))
def test_dqs_half_approximation_and_brute_force_exact(ref, seed):
    """Modified greedy is a 1/2-approximation of the exact knapsack; the
    brute-force oracle itself matches the reference's."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(4, 10))
    values = rng.uniform(0.1, 1.0, k)
    costs = rng.integers(1, k + 2, k)
    cfg = FeelConfig(n_ues=k)
    g = tsc.dqs_schedule(values, costs, cfg)
    b = tsc.brute_force_schedule(values, costs, cfg)
    _same_schedule(b, ref.sc.brute_force_schedule(values, costs,
                                                  _ref_cfg(ref, cfg)))
    assert 0.5 * b.objective() - 1e-9 <= g.objective() \
        <= b.objective() + 1e-9
    assert g.alpha.sum() <= 1.0 + 1e-9
    assert not np.any(g.x[costs > k])


def test_dqs_fallback_and_density_order(ref):
    """The modified-greedy fallback schedules the single high-value UE when
    density-greedy would block the budget with a cheap low-value one; with
    room, the density order wins."""
    values, costs = np.array([0.5, 0.9]), np.array([1, 2])
    s = tsc.dqs_schedule(values, costs, FeelConfig(n_ues=2))
    assert not s.x[0] and s.x[1] and s.alpha[1] == 1.0
    _same_schedule(s, ref.sc.dqs_schedule(values, costs,
                                          ref.cfg.FeelConfig(n_ues=2)))
    values, costs = np.array([1.0, 0.9, 0.85]), np.array([1, 1, 2])
    s = tsc.dqs_schedule(values, costs, FeelConfig(n_ues=3))
    np.testing.assert_array_equal(s.x, [True, True, False])


def test_top_value_logs_real_costs():
    values = np.array([0.9, 0.8, 0.1, 0.2, 0.3, 0.4])
    costs = np.array([7, 7, 1, 1, 1, 1])     # the two best are infeasible
    s = tsc.top_value_schedule(values, costs,
                               FeelConfig(n_ues=6, min_selected=2), 2)
    np.testing.assert_array_equal(s.cost, costs)
    assert set(s.selected) == {0, 1}


# ---------------------------------------------------------------------- #
# A forced round through the whole host control plane
# ---------------------------------------------------------------------- #
def test_forced_rounds_match_reference(ref):
    """A deadline no UE can meet: every round is forced onto the
    highest-value UE with objective 0.0, in the port as in the reference,
    with the same values, selections and host RNG stream."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.partition import partition
    from repro_torch.data.synthetic_mnist import generate
    from repro_torch.federated.server import FeelServer
    rpa, rsm = reference("data.partition"), reference("data.synthetic_mnist")
    rsv = reference("federated.server")
    cfg = FeelConfig(n_ues=4, n_malicious=0, deadline_s=1e-9)
    train, test = generate(800, 150, seed=3)
    train_r, test_r = rsm.generate(800, 150, seed=3)
    rng, rng_r = np.random.default_rng(3), np.random.default_rng(3)
    srv_r = rsv.FeelServer(_ref_cfg(ref, cfg),
                           rpa.partition(train_r, 4, rng_r), test_r, rng_r,
                           control="host")
    srv = FeelServer(cfg, partition(train, 4, rng), test, rng, device="cpu")
    srv.params = params_from_numpy(
        {k: np.asarray(v) for k, v in srv_r.params.items()}, "cpu")
    for t in range(2):
        log, log_r = srv.run_round(t), srv_r.run_round(t)
        assert log.forced and log_r.forced
        assert log.objective == log_r.objective == 0.0
        np.testing.assert_array_equal(log.selected, log_r.selected)
        assert log.selected.size == 1
        assert int(log.selected[0]) == int(np.argmax(log.values))
        if t == 0:      # later values read the data plane's accuracies
            np.testing.assert_array_equal(log.values, log_r.values)
        np.testing.assert_allclose(log.reputations, log_r.reputations,
                                   atol=5e-2)
    assert rng.integers(1 << 31) == rng_r.integers(1 << 31)
