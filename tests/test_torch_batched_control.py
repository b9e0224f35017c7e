"""The port's batched control plane (core/control.py) against the JAX
package's and against the host numpy oracle.

Tolerances, as tests/test_control.py holds the reference's layouts:

- ``schedule_runs(kernel="hybrid")`` is bit-equal to the reference's
  "hybrid" layout and to the per-run host oracle on every output (values,
  costs, selection, alpha, forced), for every policy, at K = 10 and 50,
  and in an all-infeasible round;
- the port's "device" layout on CPU tensors against the reference's "jax"
  layout: integer outputs (selection, costs, forced) exact, floats within
  rtol 1e-12 (each side may round a product or a sum otherwise than
  numpy);
- ``finalize_runs(penalties=)`` in the hybrid layout bit-equal to the
  reference's and to ``ReputationTracker.update``; the device layout
  within rtol 1e-12;
- ``run_experiment(control="batched", device="cpu")`` equal to the port's
  ``control="host"`` run (every field; the same float32 data plane), and
  to the reference's ``control="batched"`` run with its initial params
  injected: selections, ``malicious_selected`` and the host RNG's next
  draw exact, ``acc`` within 1e-2 (the tolerance of
  tests/test_torch_simulation.py).
"""
import dataclasses
import types

import numpy as np
import pytest
import torch
from torch_parity import (nan64, ref_init_task, reference,  # noqa: F401
                          run_recorded, single_threaded)

from repro_torch.configs.base import FeelConfig
from repro_torch.core import control as ctl
from repro_torch.core import diversity as tdi
from repro_torch.core import reputation as tre
from repro_torch.core import scheduler as tsc
from repro_torch.core import wireless as twl
from repro_torch.core.quality import data_quality_value
from repro_torch.federated import simulation

POLICIES = list(tsc.POLICY_IDS)


@pytest.fixture(scope="module")
def ref():
    return types.SimpleNamespace(
        cfg=reference("configs.base"), ctl=reference("core.control"),
        sc=reference("core.scheduler"))


class _Replay:
    """numpy-Generator stand-in replaying one pre-drawn permutation."""

    def __init__(self, perm):
        self.perm = perm

    def permutation(self, n):
        assert n == len(self.perm)
        return self.perm


def _instance(seed, k, r=10, deadline=None):
    """R runs x K UEs of random control state (every policy in turn) and
    one round of draws — tests/test_control.py's generator."""
    rng = np.random.default_rng(seed)
    cfg = FeelConfig(n_ues=k, **({} if deadline is None
                                 else {"deadline_s": deadline}))
    wms = [twl.WirelessModel(cfg, np.random.default_rng(seed * 100 + i))
           for i in range(r)]
    sizes = (rng.integers(1, 31, (r, k)) * 50).astype(float)
    cpu = rng.uniform(cfg.cpu_hz_min, cfg.cpu_hz_max, (r, k))
    t_train = np.stack([wms[i].train_time(sizes[i], cpu[i])
                        for i in range(r)])
    policies = [POLICIES[i % len(POLICIES)] for i in range(r)]
    state = ctl.ControlState(
        policy_id=np.array([tsc.POLICY_IDS[p] for p in policies], np.int32),
        sizes=sizes, divs=rng.uniform(0, 0.9, (r, k)),
        r_min=np.stack([wms[i].min_rate(t_train[i]) for i in range(r)]),
        reputations=rng.uniform(0, 1, (r, k)),
        ages=rng.integers(1, 6, (r, k)).astype(float), cfg=cfg)
    gains = np.stack([wms[i].draw_channels().gains for i in range(r)])
    perms = [rng.permutation(k) for _ in range(r)]
    rand_rank = np.stack([np.argsort(p) for p in perms])
    omega = (rng.uniform(0.2, 0.8, r), rng.uniform(0.2, 0.8, r))
    return types.SimpleNamespace(cfg=cfg, wms=wms, t_train=t_train,
                                 policies=policies, state=state, gains=gains,
                                 perms=perms, rand_rank=rand_rank,
                                 omega=omega)


def _ref_state(ref, state):
    return ref.ctl.ControlState(
        policy_id=state.policy_id.copy(), sizes=state.sizes.copy(),
        divs=state.divs.copy(), r_min=state.r_min.copy(),
        reputations=state.reputations.copy(), ages=state.ages.copy(),
        cfg=ref.cfg.FeelConfig(**dataclasses.asdict(state.cfg)))


def _host_schedule(inst, i):
    """Run i through the port's host oracle (FeelServer's host path,
    recomposed from the per-equation numpy functions)."""
    cfg, st, p = inst.cfg, inst.state, inst.policies[i]
    I = tdi.diversity_index(st.divs[i], st.sizes[i], st.ages[i], cfg.gamma)
    values = data_quality_value(st.reputations[i], I, cfg,
                                omega=(inst.omega[0][i], inst.omega[1][i]))
    costs = inst.wms[i].cost(inst.gains[i], inst.t_train[i])
    if p == "top_value":
        s = tsc.top_value_schedule(values, costs, cfg, cfg.min_selected)
    elif p == "random":
        s = tsc.random_schedule(values, costs, cfg, _Replay(inst.perms[i]))
    elif p == "best_channel":
        s = tsc.best_channel_schedule(values, costs, cfg, inst.gains[i])
    elif p == "max_count":
        s = tsc.max_count_schedule(values, costs, cfg)
    else:
        s = tsc.dqs_schedule(values, costs, cfg)
    x, alpha, forced = s.x.copy(), s.alpha.copy(), False
    if not x.any():
        k = int(np.argmax(values))
        x[k], alpha[:], forced = True, 0.0, True
        alpha[k] = 1.0
    return x, alpha, costs, values, forced


def _schedule(inst, kernel, mod=ctl, state=None):
    return mod.schedule_runs(inst.state if state is None else state,
                             inst.gains, inst.rand_rank, *inst.omega,
                             kernel=kernel)


def _assert_bit_equal(got, want, what=""):
    for name, a, b in zip(("x", "alpha", "costs", "values", "forced"),
                          got, want):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {name}")


def _assert_ints_exact_floats_close(got, want, rtol=1e-12):
    for name, a, b in zip(("x", "alpha", "costs", "values", "forced"),
                          got, want):
        if name in ("alpha", "values"):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


CASES = [(seed, k) for seed in (0, 1, 2) for k in (10, 50)]


# ---------------------------------------------------------------------- #
# schedule_runs
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,k", CASES)
def test_hybrid_bit_equal_to_reference_and_host_oracle(ref, seed, k):
    inst = _instance(seed, k)
    got = _schedule(inst, "hybrid")
    _assert_bit_equal(got, _schedule(inst, "hybrid", ref.ctl,
                                     _ref_state(ref, inst.state)),
                      "reference")
    for i, p in enumerate(inst.policies):
        _assert_bit_equal([a[i] for a in got], _host_schedule(inst, i), p)


@pytest.mark.parametrize("seed,k", CASES)
def test_device_layout_matches_reference_jax_layout(ref, seed, k):
    inst = _instance(seed, k)
    got = _schedule(inst, "device")
    _assert_ints_exact_floats_close(
        got, _schedule(inst, "jax", ref.ctl, _ref_state(ref, inst.state)))
    _assert_ints_exact_floats_close(got, _schedule(inst, "hybrid"))


def test_all_infeasible_round(ref):
    """A blown deadline: every cost is K+1, and every policy but top_value
    (which ignores the channel) is forced onto its highest-value UE with
    the whole band — in both layouts, as in the reference's."""
    inst = _instance(3, 12, deadline=1e-6)
    hyb = _schedule(inst, "hybrid")
    _assert_bit_equal(hyb, _schedule(inst, "hybrid", ref.ctl,
                                     _ref_state(ref, inst.state)))
    _assert_ints_exact_floats_close(_schedule(inst, "device"), hyb)
    x, alpha, costs, values, forced = hyb
    assert np.all(costs == inst.cfg.n_ues + 1)
    for i, p in enumerate(inst.policies):
        assert forced[i] == (p != "top_value"), p
        if p != "top_value":
            k = int(np.argmax(values[i]))
            assert np.flatnonzero(x[i]).tolist() == [k]
            assert alpha[i, k] == 1.0


def test_default_layout_follows_the_device():
    assert ctl.default_kernel("cpu") == "hybrid"
    assert ctl.default_kernel(torch.device("cuda")) == "device"
    inst = _instance(0, 10)
    with pytest.raises(ValueError, match="layout"):
        _schedule(inst, "jax")


def _odd_keys(seed, r=6, n=40):
    """(R, N) float64 priority keys from a small set, so that ties are
    many: NaNs of both signs and two payloads, +-inf, +-0 and a few
    numbers; row 0 all NaN, row 1 only NaN and +inf."""
    rng = np.random.default_rng(seed)
    pool = np.array([nan64(1), nan64(-1), nan64(1, 0x77), nan64(-1, 0x77),
                     np.inf, -np.inf, 0.0, -0.0, 1.5, -1.5, 2.0, 1e-300])
    keys = pool[rng.integers(0, len(pool), (r, n))]
    keys[0] = pool[rng.integers(0, 4, n)]
    keys[1] = pool[rng.integers(0, 5, n)]
    return keys


@pytest.mark.parametrize("seed", range(4))
def test_nan_priority_keys_sort_as_numpy(seed):
    """``greedy_pack_rows`` on keys holding NaN (both signs, two
    payloads), +-inf and +-0 ties: ``scheduler.order_key``'s stable
    argsort is numpy's stable argsort (NaN last in index order, -0 tied
    with +0), and the pack is ``greedy_pack`` over that order, row by
    row."""
    keys = _odd_keys(seed)
    want_order = np.argsort(keys, axis=-1, kind="stable")
    got_order = torch.argsort(tsc.order_key(torch.from_numpy(keys)), dim=-1,
                              stable=True).numpy()
    np.testing.assert_array_equal(got_order, want_order)
    rng = np.random.default_rng(seed + 100)
    k = 10
    costs = rng.integers(1, k + 2, keys.shape).astype(np.int32)
    x, alpha = tsc.greedy_pack_rows(torch.from_numpy(keys),
                                    torch.from_numpy(costs), k)
    for i in range(len(keys)):
        hx, ha = tsc.greedy_pack(want_order[i], costs[i], k)
        np.testing.assert_array_equal(x[i].numpy(), hx)
        np.testing.assert_array_equal(alpha[i].numpy(), ha)


NAN_CELLS = ((0, 3, 1, 0), (0, 7, -1, 0x1234), (1, 5, -1, 0),
             (2, 1, 1, 0x1234), (3, 0, -1, 0x1234), (4, 9, 1, 0),
             (4, 2, -1, 0), (5, 4, 1, 0), (5, 6, -1, 0), (7, 8, 1, 0x1234),
             (9, 0, -1, 0))


@pytest.mark.parametrize("infeasible", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_nan_reputations_schedule_as_the_reference(ref, policy, infeasible):
    """NaN reputations (both signs, two payloads, several runs, two in a
    row) make NaN values and dqs / top_value priority keys. Every run of
    one policy, and a round where every UE is infeasible (the forced
    rewrite takes the first NaN value): the port's "device" layout on CPU
    tensors, its "hybrid" layout and the reference's "jax" and "hybrid"
    layouts give the same selection, alpha, costs and forced, exactly;
    values NaN where NaN, the rest within rtol 1e-12."""
    inst = _instance(7, 10, deadline=1e-6 if infeasible else None)
    st = inst.state
    st.policy_id[:] = tsc.POLICY_IDS[policy]
    for i, j, sign, payload in NAN_CELLS:
        st.reputations[i, j] = nan64(sign, payload)
    outs = {"device": _schedule(inst, "device"),
            "hybrid": _schedule(inst, "hybrid"),
            "ref jax": _schedule(inst, "jax", ref.ctl, _ref_state(ref, st)),
            "ref hybrid": _schedule(inst, "hybrid", ref.ctl,
                                    _ref_state(ref, st))}
    want = outs["ref hybrid"]
    assert np.isnan(want[3]).sum() == len(NAN_CELLS)
    for label, got in outs.items():
        for i in (0, 1, 2, 4):
            np.testing.assert_array_equal(np.asarray(got[i]), want[i],
                                          err_msg=f"{label} {i}")
        np.testing.assert_allclose(np.asarray(got[3]), want[3], rtol=1e-12,
                                   atol=0, equal_nan=True, err_msg=label)
    if infeasible:
        assert np.asarray(want[4]).all() == (policy != "top_value")
    x, values = outs["device"][0], outs["device"][3]
    if policy == "top_value":        # NaN keys sort last: past the top n
        assert not (x & np.isnan(values)).any()
    if policy == "dqs" and not infeasible:   # the walk reaches them last
        assert (x & np.isnan(values)).any()


# ---------------------------------------------------------------------- #
# The per-equation tensor twins against the numpy host functions
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,k", CASES)
def test_tensor_twins_equal_the_host_functions(seed, k):
    inst = _instance(seed, k)
    st = inst.state
    t = torch.from_numpy
    # Eq. 9: the bisection over tensors == WirelessModel.cost
    costs = twl.cost_bisect(t(inst.gains), t(st.r_min), k,
                            inst.cfg.bandwidth_hz, inst.cfg.p_watt,
                            inst.cfg.n0_watt_hz).numpy()
    for i in range(st.n_runs):
        np.testing.assert_array_equal(
            costs[i], inst.wms[i].cost(inst.gains[i], inst.t_train[i]))
    alpha = np.linspace(0.0, 1.0, k)
    np.testing.assert_array_equal(
        twl.rate_eq4(t(inst.gains[0]), t(alpha), inst.cfg.bandwidth_hz,
                     inst.cfg.p_watt, inst.cfg.n0_watt_hz).numpy(),
        inst.wms[0].rate(inst.gains[0], alpha))
    # Eq. 2: the tensor twin == the numpy rows == the per-run host
    gamma = inst.cfg.gamma
    rows = tdi.diversity_index_rows(st.divs, st.sizes, st.ages,
                                    np.asarray(gamma, float))
    np.testing.assert_array_equal(
        tdi.diversity_index_eq2(t(st.divs), t(st.sizes), t(st.ages),
                                gamma).numpy(), rows)
    np.testing.assert_array_equal(
        rows[1], tdi.diversity_index(st.divs[1], st.sizes[1], st.ages[1],
                                     gamma))
    # Alg. 2's pack: greedy_pack_rows == greedy_pack per row
    key = np.random.default_rng(seed).permutation(st.n_runs * k).reshape(
        st.n_runs, k).astype(float)
    x, a = tsc.greedy_pack_rows(t(key), t(costs), k)
    for i in range(st.n_runs):
        hx, ha = tsc.greedy_pack(np.argsort(key[i], kind="stable"),
                                 costs[i], k)
        np.testing.assert_array_equal(x[i].numpy(), hx)
        np.testing.assert_array_equal(a[i].numpy(), ha)


# ---------------------------------------------------------------------- #
# finalize_runs
# ---------------------------------------------------------------------- #
def _finalize_instance(seed, r=6, k=12):
    rng = np.random.default_rng(seed)
    cfg = FeelConfig(n_ues=k)
    state = ctl.ControlState(
        policy_id=np.zeros(r, np.int32), sizes=np.ones((r, k)),
        divs=np.ones((r, k)), r_min=np.ones((r, k)),
        reputations=rng.uniform(0, 1, (r, k)),
        ages=rng.integers(1, 10, (r, k)).astype(float), cfg=cfg)
    n_sel = rng.integers(1, k, r)
    sels = [rng.choice(k, size=n, replace=False) for n in n_sel]
    accs_l = [rng.uniform(0, 1, n) for n in n_sel]
    accs_t = [rng.uniform(0, 1, n) for n in n_sel]
    pens = [None if i % 3 == 0 else rng.uniform(0, 0.3, n)
            for i, n in enumerate(n_sel)]
    return state, sels, accs_l, accs_t, pens


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_finalize_runs_with_penalties(ref, seed):
    state, sels, accs_l, accs_t, pens = _finalize_instance(seed)
    rep0, ages0 = state.reputations.copy(), state.ages.copy()
    ref_state = _ref_state(ref, state)
    dev_state = dataclasses.replace(state, reputations=rep0.copy(),
                                    ages=ages0.copy())
    ctl.finalize_runs(state, sels, accs_l, accs_t, penalties=pens,
                      kernel="hybrid")
    ref.ctl.finalize_runs(ref_state, sels, accs_l, accs_t, penalties=pens,
                          kernel="hybrid")
    np.testing.assert_array_equal(state.reputations, ref_state.reputations)
    np.testing.assert_array_equal(state.ages, ref_state.ages)
    for i in range(state.n_runs):
        rt = tre.ReputationTracker(state.cfg)
        rt.values = rep0[i].copy()
        rt.update(sels[i], accs_l[i], accs_t[i], penalty=pens[i])
        np.testing.assert_array_equal(state.reputations[i], rt.values)
        want_ages = ages0[i] + 1.0
        want_ages[sels[i]] = 1.0
        np.testing.assert_array_equal(state.ages[i], want_ages)
    ctl.finalize_runs(dev_state, sels, accs_l, accs_t, penalties=pens,
                      kernel="device")
    np.testing.assert_allclose(dev_state.reputations, state.reputations,
                               rtol=1e-12, atol=0)
    np.testing.assert_array_equal(dev_state.ages, state.ages)


# ---------------------------------------------------------------------- #
# staleness_discount
# ---------------------------------------------------------------------- #
def test_staleness_discount(ref):
    ages = np.array([0, 1, 2, 7, 30])
    for decay in (0.5, 0.9, 1.0):
        got = ctl.staleness_discount(ages, decay)
        np.testing.assert_array_equal(
            got, ref.ctl.staleness_discount(ages, decay))
        assert got[0] == 1.0 and got.dtype == np.float64
    for decay in (0.0, 1.5):
        with pytest.raises(ValueError):
            ctl.staleness_discount(ages, decay)
    with pytest.raises(ValueError):
        ctl.staleness_discount(np.array([1, -1]), 0.5)


# ---------------------------------------------------------------------- #
# End to end through run_experiment (tests/test_control.py's contracts)
# ---------------------------------------------------------------------- #
KW = dict(n_train=1500, n_test=300, rounds=3, seed=0)


def _cfg(mod):
    return mod.FeelConfig(n_ues=10, n_malicious=2, min_selected=3)


@pytest.fixture(scope="module")
def e2e_runs():
    """{(policy, defense): {"batched", "host": the port's runs on the CPU,
    "ref": the reference's control="batched" run}}, each (result, server,
    the host RNG's next draw); the reference's initial params injected
    into the port's."""
    sim_r = reference("federated.simulation")
    cfg_r = _cfg(reference("configs.base"))
    task = ref_init_task()
    out = {}
    for policy, defense in (("dqs", "none"), ("random", "none"),
                            ("top_value", "none"),
                            ("dqs", "trimmed_mean+validation")):
        kw = dict(policy=policy, defense=defense, **KW)
        runs = {c: run_recorded(simulation, cfg=_cfg(simulation),
                                control=c, task=task, device="cpu", **kw)
                for c in ("batched", "host")}
        runs["ref"] = run_recorded(sim_r, cfg=cfg_r, control="batched", **kw)
        out[policy, defense] = {c: (res, srv, srv.rng.integers(1 << 31))
                                for c, (res, srv) in runs.items()}
    return out


RUNS = [("dqs", "none"), ("random", "none"), ("top_value", "none"),
        ("dqs", "trimmed_mean+validation")]


@pytest.mark.parametrize("policy,defense", RUNS)
def test_run_experiment_batched_equals_host(e2e_runs, policy, defense):
    (b, srv_b, next_b), (h, srv_h, next_h) = (
        e2e_runs[policy, defense][c] for c in ("batched", "host"))
    assert srv_b.control == "batched" and srv_h.control == "host"
    for f in b:
        np.testing.assert_array_equal(np.asarray(b[f]), np.asarray(h[f]),
                                      err_msg=f)
    for lb, lh in zip(srv_b.logs, srv_h.logs):
        np.testing.assert_array_equal(lb.selected, lh.selected)
        np.testing.assert_array_equal(lb.values, lh.values)
        np.testing.assert_array_equal(lb.reputations, lh.reputations)
    assert next_b == next_h


@pytest.mark.parametrize("policy,defense", RUNS)
def test_run_experiment_batched_matches_reference(e2e_runs, policy,
                                                  defense):
    (got, srv, next_got), (want, srv_r, next_want) = (
        e2e_runs[policy, defense][c] for c in ("batched", "ref"))
    assert len(srv.logs) == len(srv_r.logs) == KW["rounds"]
    for log, rl in zip(srv.logs, srv_r.logs):
        np.testing.assert_array_equal(log.selected, rl.selected)
        assert log.forced == rl.forced
    for f in ("malicious_selected", "n_rejected", "n_flagged", "malicious"):
        assert got[f] == want[f], f
    np.testing.assert_allclose(got["acc"], want["acc"], atol=1e-2)
    assert next_got == next_want


def test_device_layout_drives_a_run_like_the_host_oracle(monkeypatch):
    """The card's layout, forced on CPU tensors, through FeelServer: the
    same selections and curves as the host control plane."""
    kw = dict(cfg=_cfg(simulation), policy="dqs", device="cpu", **KW)
    host = simulation.run_experiment(control="host", **kw)
    monkeypatch.setattr(ctl, "default_kernel", lambda device: "device")
    got = simulation.run_experiment(control="batched", **kw)
    assert got["malicious_selected"] == host["malicious_selected"]
    np.testing.assert_array_equal(got["acc"], host["acc"])
    np.testing.assert_allclose(got["objective"], host["objective"],
                               rtol=1e-12)
