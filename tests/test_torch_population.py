"""The port's population plane (core/population.py) and its width-free
budget walk (``scheduler.pack_scan``), against the JAX package's and
against the exact schedule.

Tolerances, as tests/test_population.py holds the reference's:

- ``pack_scan`` bit for bit against the N-step walk it replaced (kept here
  as the oracle) and against ``greedy_pack``, at K from 1 to 64 and N up to
  10^4, with heavy ties, every cost K + 1 and cost-1 floods; its steps are
  at most K + 1, whatever N;
- ``prefilter_schedule_runs(kernel="hybrid")`` bit-equal to the exact
  hybrid schedule and to the reference's hybrid prefilter (every output and
  ``info``), for every policy, at M from ``min_selected`` (rows escalate)
  to N;
- the "device" layout on CPU tensors: integer outputs (selection, costs,
  forced) and ``n_escalated`` equal to the hybrid layout's and the exact
  path's, floats within rtol 1e-12 of the reference's "jax" layout;
- the kept set of either layout is the stable argsort prefix, ties at the
  pivot too; ``scatter_finalize`` bit-equal to the dense hybrid
  ``finalize_runs`` and to the reference's;
- ``run_experiment(population=N)`` equal to its ``run_sweep`` twin and
  ``population=K`` to ``population=None`` on every curve; against the
  reference's run with its initial params injected: selections and
  ``malicious_selected`` exact, ``acc`` within 1e-2.
"""
import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
from torch_parity import (nan64, ref_init_task, reference,  # noqa: F401
                          run_recorded, single_threaded)

from repro_torch.configs.base import FeelConfig
from repro_torch.core import control as ctl
from repro_torch.core import population as pop
from repro_torch.core import scheduler as tsc
from repro_torch.federated import simulation

POLICIES = list(tsc.POLICY_IDS)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def ref():
    return types.SimpleNamespace(
        cfg=reference("configs.base"), ctl=reference("core.control"),
        pop=reference("core.population"),
        sim=reference("federated.simulation"))


# ---------------------------------------------------------------------- #
# pack_scan: the budget walk, width-free
# ---------------------------------------------------------------------- #
def _walk(c_sorted: torch.Tensor, k: int) -> torch.Tensor:
    """The N-step walk ``pack_scan`` was until it jumped from take to take:
    the remaining budget carried through every sorted position."""
    budget = torch.full(c_sorted.shape[:-1], k, dtype=c_sorted.dtype)
    takes = []
    for c in c_sorted.unbind(-1):
        take = (c <= k) & (c <= budget)
        budget = budget - torch.where(take, c, 0)
        takes.append(take)
    return torch.stack(takes, -1)


def _costs(kind, k, n, r, rng):
    if kind == "random":
        return rng.integers(1, k + 2, (r, n))
    if kind == "ties":              # two cost values only
        return rng.choice([1, max(k // 2, 1)], (r, n))
    if kind == "infeasible":        # every cost K + 1
        return np.full((r, n), k + 1)
    if kind == "cost1_flood":
        c = np.ones((r, n), int)
        c[:, ::7] = k + 1
        return c
    raise KeyError(kind)


PACK_CASES = [(k, n, kind) for k, n in ((1, 40), (2, 300), (7, 1000),
                                        (50, 2000), (64, 10_000))
              for kind in ("random", "ties", "infeasible", "cost1_flood")]


@pytest.mark.parametrize("k,n,kind", PACK_CASES)
def test_pack_scan_equals_the_n_step_walk(k, n, kind):
    rng = np.random.default_rng(k * 1000 + n)
    c = torch.as_tensor(_costs(kind, k, n, 4, rng), dtype=torch.int32)
    got = tsc.pack_scan(c, k)
    assert torch.equal(got, _walk(c, k))
    assert got.shape == c.shape and got.dtype == torch.bool
    # and against the host greedy on the identity order
    for i in range(c.shape[0]):
        x, _ = tsc.greedy_pack(np.arange(n), c[i].numpy(), k)
        np.testing.assert_array_equal(got[i].numpy(), x)


def test_pack_scan_leading_axes_and_zero_costs():
    rng = np.random.default_rng(5)
    c = torch.as_tensor(rng.integers(0, 4, (2, 3, 50)), dtype=torch.int32)
    assert torch.equal(tsc.pack_scan(c, 6), _walk(c, 6))


@pytest.mark.parametrize("k,n", [(1, 10_000), (8, 10_000), (64, 10_000)])
def test_pack_scan_steps_do_not_grow_with_n(monkeypatch, k, n):
    """One ``torch.where`` a step: at most K + 1 steps, not N."""
    calls = []
    real = torch.where

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    c = torch.as_tensor(np.random.default_rng(k).integers(1, 3, (5, n)),
                        dtype=torch.int32)
    monkeypatch.setattr(torch, "where", counting)
    tsc.pack_scan(c, k)
    assert 1 <= len(calls) <= k + 1, len(calls)


def test_greedy_pack_rows_uses_the_new_walk():
    rng = np.random.default_rng(3)
    key = torch.as_tensor(rng.integers(0, 5, (6, 300)).astype(float))
    costs = torch.as_tensor(rng.integers(1, 12, (6, 300)), dtype=torch.int32)
    x, alpha = tsc.greedy_pack_rows(key, costs, 10)
    for i in range(6):
        hx, ha = tsc.greedy_pack(np.argsort(key[i].numpy(), kind="stable"),
                                 costs[i].numpy(), 10)
        np.testing.assert_array_equal(x[i].numpy(), hx)
        np.testing.assert_array_equal(alpha[i].numpy(), ha)


# ---------------------------------------------------------------------- #
# The prefilter against the exact schedule and the reference
# ---------------------------------------------------------------------- #
def _instance(seed, k, n, r=10):
    """R runs x N candidates of random control state cycling the five
    policies (tests/test_population.py's generator)."""
    rng = np.random.default_rng(seed)
    cfg = FeelConfig(n_ues=k, population=n)
    state = ctl.ControlState(
        policy_id=np.array([tsc.POLICY_IDS[POLICIES[i % 5]]
                            for i in range(r)], np.int32),
        sizes=rng.uniform(100, 3000, (r, n)),
        divs=rng.uniform(0, 1, (r, n)),
        r_min=rng.uniform(1e4, 1e7, (r, n)),
        reputations=rng.uniform(0, 1, (r, n)),
        ages=rng.integers(1, 10, (r, n)).astype(float), cfg=cfg)
    gains = rng.exponential(1e-9, (r, n))
    rand_rank = np.stack([np.argsort(rng.permutation(n)) for _ in range(r)])
    omega = (np.full(r, cfg.omega_rep), np.full(r, cfg.omega_div))
    return cfg, state, gains, rand_rank, omega


def _ref_state(ref, state):
    return ref.ctl.ControlState(
        policy_id=state.policy_id.copy(), sizes=state.sizes.copy(),
        divs=state.divs.copy(), r_min=state.r_min.copy(),
        reputations=state.reputations.copy(), ages=state.ages.copy(),
        cfg=ref.cfg.FeelConfig(**dataclasses.asdict(state.cfg)))


NAMES = ("x", "alpha", "costs", "values", "forced")
PREFILTER_CASES = [(seed, k, f) for seed, k, f in
                   ((0, 4, 2), (1, 8, 5), (2, 12, 12), (3, 6, 12),
                    (4, 10, 5), (5, 5, 2))]


def _ms(cfg, k, n):
    return sorted({cfg.min_selected, max(k, cfg.min_selected), 2 * k, n})


@pytest.mark.parametrize("seed,k,n_factor", PREFILTER_CASES)
def test_hybrid_prefilter_equals_exact_and_reference(ref, seed, k,
                                                     n_factor):
    n = k * n_factor
    cfg, state, gains, rand_rank, omega = _instance(seed, k, n)
    exact = ctl.schedule_runs(state, gains, rand_rank, *omega,
                              kernel="hybrid")
    for m in _ms(cfg, k, n):
        *got, info = pop.prefilter_schedule_runs(
            state, gains, rand_rank, *omega, m=m, kernel="hybrid")
        *want, info_r = ref.pop.prefilter_schedule_runs(
            _ref_state(ref, state), gains, rand_rank, *omega, m=m,
            kernel="hybrid")
        for name, a, b, e in zip(NAMES, got, want, exact):
            np.testing.assert_array_equal(a, e, err_msg=f"m={m} {name}")
            np.testing.assert_array_equal(a, b, err_msg=f"m={m} {name} ref")
        assert info == info_r and info["m"] == min(m, n)


@pytest.mark.parametrize("seed,k,n_factor", PREFILTER_CASES)
def test_device_prefilter_equals_exact_and_reference_jax(ref, seed, k,
                                                         n_factor):
    n = k * n_factor
    cfg, state, gains, rand_rank, omega = _instance(seed, k, n)
    exact = ctl.schedule_runs(state, gains, rand_rank, *omega,
                              kernel="device")
    for m in _ms(cfg, k, n):
        *got, info = pop.prefilter_schedule_runs(
            state, gains, rand_rank, *omega, m=m, kernel="device")
        *hyb, info_h = pop.prefilter_schedule_runs(
            state, gains, rand_rank, *omega, m=m, kernel="hybrid")
        *want, _ = ref.pop.prefilter_schedule_runs(
            _ref_state(ref, state), gains, rand_rank, *omega, m=m,
            kernel="jax")
        assert info == info_h, (m, info, info_h)
        for name, a, b, h, e in zip(NAMES, got, want, hyb, exact):
            if name in ("alpha", "values"):
                np.testing.assert_allclose(a, b, rtol=1e-12, atol=0,
                                           err_msg=f"m={m} {name}")
                np.testing.assert_allclose(a, h, rtol=1e-12, atol=0)
                np.testing.assert_array_equal(a, e, err_msg=f"m={m} {name}")
            else:
                for other in (b, h, e):
                    np.testing.assert_array_equal(a, other,
                                                  err_msg=f"m={m} {name}")


def test_escalation_is_exercised(ref):
    """At M = min_selected the certificate fails on some rows, and the
    layouts escalate the same rows as the reference's; a full-width M never
    escalates."""
    esc = {"hybrid": 0, "device": 0}
    for seed in range(5):
        cfg, state, gains, rand_rank, omega = _instance(seed, 8, 64)
        exact = ctl.schedule_runs(state, gains, rand_rank, *omega,
                                  kernel="hybrid")
        *_, info_r = ref.pop.prefilter_schedule_runs(
            _ref_state(ref, state), gains, rand_rank, *omega,
            m=cfg.min_selected, kernel="hybrid")
        for kern in esc:
            x, _, costs, _, forced, info = pop.prefilter_schedule_runs(
                state, gains, rand_rank, *omega, m=cfg.min_selected,
                kernel=kern)
            np.testing.assert_array_equal(x, exact[0])
            np.testing.assert_array_equal(costs, exact[2])
            np.testing.assert_array_equal(forced, exact[4])
            assert info["n_escalated"] == info_r["n_escalated"]
            esc[kern] += info["n_escalated"]
    assert esc["hybrid"] == esc["device"] > 0, esc
    *_, info = pop.prefilter_schedule_runs(state, gains, rand_rank, *omega,
                                           m=64, kernel="device")
    assert info == {"m": 64, "n_escalated": 0}


def test_prefilter_refuses_a_width_below_min_selected_and_schedules_nan_keys(
        ref):
    """A width below ``min_selected`` raises; NaN reputations (the
    instance of ROADMAP P9) are scheduled, both layouts giving the
    reference's exact schedule ("jax" and "hybrid" agree on it)."""
    cfg, state, gains, rand_rank, omega = _instance(0, 8, 40)
    with pytest.raises(ValueError, match="min_selected"):
        pop.prefilter_schedule_runs(state, gains, rand_rank, *omega,
                                    m=cfg.min_selected - 1)
    state.reputations[0, 3] = state.reputations[1, 5] = np.nan
    want = {kern: ref.ctl.schedule_runs(_ref_state(ref, state), gains,
                                        rand_rank, *omega, kernel=kern)
            for kern in ("jax", "hybrid")}
    for kern in ("device", "hybrid"):
        *got, _ = pop.prefilter_schedule_runs(state, gains, rand_rank,
                                              *omega, m=16, kernel=kern)
        for w in want.values():
            for i in (0, 1, 2, 4):
                np.testing.assert_array_equal(got[i], w[i])


# (run, candidate, sign, payload): dqs runs 0 and 5, top_value 4 and 9,
# and a NaN in each other policy's run; runs 0 and 4 also get a crowd
NAN_CELLS = ((0, 3, -1, 0), (0, 7, 1, 0x1234), (1, 5, -1, 0x77),
             (2, 1, 1, 0), (3, 0, -1, 0), (4, 39, 1, 0), (4, 2, -1, 0),
             (5, 11, 1, 0x77), (9, 20, -1, 0x1234))


def _nan_instance(k, n, crowd):
    """``_instance(1, k, n)`` with NaN reputations at ``NAN_CELLS`` and,
    with ``crowd``, all but k + 2 candidates of runs 0 (dqs) and 4
    (top_value) NaN, so that NaN keys tie at the M-th key and fill the
    kept prefix."""
    cfg, state, gains, rand_rank, omega = _instance(1, k, n)
    for i, j, sign, payload in NAN_CELLS:
        state.reputations[i, j] = nan64(sign, payload)
    if crowd:
        rng = np.random.default_rng(n)
        for i in (0, 4):
            cols = rng.choice(n, n - k - 2, replace=False)
            state.reputations[i, cols] = [nan64((-1) ** c, c % 3)
                                          for c in cols]
    return cfg, state, gains, rand_rank, omega


@pytest.mark.parametrize("crowd", [False, True])
@pytest.mark.parametrize("k,n", [(8, 40), (6, 72)])
def test_prefilter_with_nan_keys_is_the_exact_schedule(ref, k, n, crowd):
    """NaN priority keys (both signs, payloads; crowded past M): the
    prefilter's "device" and "hybrid" layouts give the exact schedule's
    selection, alpha, costs and forced exactly, at every M, and the same
    escalations; the exact schedule is the reference's ("hybrid" exactly,
    "jax" with alpha within rtol 1e-12); values NaN where NaN."""
    cfg, state, gains, rand_rank, omega = _nan_instance(k, n, crowd)
    exact = ctl.schedule_runs(state, gains, rand_rank, *omega,
                              kernel="hybrid")
    for kern in ("jax", "hybrid"):
        want = ref.ctl.schedule_runs(_ref_state(ref, state), gains,
                                     rand_rank, *omega, kernel=kern)
        for i in (0, 2, 4):
            np.testing.assert_array_equal(exact[i], want[i], err_msg=kern)
        # "jax" rounds a top_value alpha otherwise (1 ulp), NaN or not
        np.testing.assert_allclose(exact[1], want[1], rtol=1e-12, atol=0,
                                   err_msg=kern)
        if kern == "hybrid":
            np.testing.assert_array_equal(exact[1], want[1])
    for m in _ms(cfg, k, n) + [n - 1]:
        infos = {}
        for kern in ("device", "hybrid"):
            *got, infos[kern] = pop.prefilter_schedule_runs(
                state, gains, rand_rank, *omega, m=m, kernel=kern)
            for i in (0, 1, 2, 4):
                np.testing.assert_array_equal(got[i], exact[i],
                                              err_msg=f"{kern} m={m} {i}")
            np.testing.assert_allclose(got[3], exact[3], rtol=1e-12,
                                       equal_nan=True)
        assert infos["device"] == infos["hybrid"], (m, infos)


def test_r10_the_reference_prefilter_misorders_nan_keys(ref):
    """ROADMAP R10: the reference's own prefilter disagrees with its exact
    schedule on NaN keys. Its "jax" layout takes ``lax.top_k(values,
    n_sel)`` for a top_value row, which puts a positive NaN value first
    (run 4 takes candidate 39 in place of 3); its "hybrid" layout's prefix
    (``_topm_prefix``) finds no key below a NaN pivot and raises once M
    passes a row's numbers. The port follows the exact schedule (the test
    above)."""
    cfg, state, gains, rand_rank, omega = _nan_instance(8, 40, False)
    rs = _ref_state(ref, state)
    exact = ref.ctl.schedule_runs(rs, gains, rand_rank, *omega,
                                  kernel="hybrid")
    x, *_ = ref.pop.prefilter_schedule_runs(rs, gains, rand_rank, *omega,
                                            m=16, kernel="jax")
    differ = np.flatnonzero((x != exact[0]).any(-1))
    assert differ.tolist() == [4]
    assert x[4, 39] and not x[4, 3] and exact[0][4, 3]
    *_, info = ref.pop.prefilter_schedule_runs(rs, gains, rand_rank, *omega,
                                               m=16, kernel="hybrid")
    with pytest.raises(ValueError, match="broadcast"):
        ref.pop.prefilter_schedule_runs(rs, gains, rand_rank, *omega, m=39,
                                        kernel="hybrid")


def test_all_infeasible_population_round():
    cfg, state, gains, rand_rank, omega = _instance(2, 8, 80)
    gains[:] = 0.0                      # every cost K + 1
    exact = ctl.schedule_runs(state, gains, rand_rank, *omega,
                              kernel="hybrid")
    for kern in ("hybrid", "device"):
        *got, _ = pop.prefilter_schedule_runs(state, gains, rand_rank,
                                              *omega, m=16, kernel=kern)
        for name, a, e in zip(NAMES, got, exact):
            np.testing.assert_array_equal(a, e, err_msg=f"{kern} {name}")
    top = state.policy_id == tsc.POLICY_IDS["top_value"]
    np.testing.assert_array_equal(exact[4], ~top)


# ---------------------------------------------------------------------- #
# The kept set: the stable argsort prefix, ties at the pivot too
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(8))
def test_kept_set_is_the_stable_argsort_prefix(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 6, (4, 40)).astype(float)
    keys[1, ::3] = -0.0                 # signed zeros tie with 0.0
    for m in (3, 7, 13, 30, 39):
        want = np.argsort(keys, axis=-1, kind="stable")[:, :m]
        np.testing.assert_array_equal(pop._topm_prefix(keys, m), want)
        np.testing.assert_array_equal(
            pop._topm_prefix_rows(torch.as_tensor(keys), m).numpy(), want)


@pytest.mark.parametrize("seed", range(4))
def test_kept_set_with_nan_keys_is_the_stable_argsort_prefix(seed):
    """NaN keys of both signs and payloads, +-inf and +-0: the kept set of
    either layout is numpy's stable argsort prefix (NaN last, in index
    order), M reaching into the NaN keys too."""
    rng = np.random.default_rng(seed)
    pool = np.array([nan64(1), nan64(-1), nan64(1, 5), nan64(-1, 5),
                     np.inf, -np.inf, 0.0, -0.0, 1.0, 2.0])
    keys = pool[rng.integers(0, len(pool), (4, 40))]
    keys[0, :30] = nan64(-1)
    for m in (3, 7, 13, 30, 39):
        want = np.argsort(keys, axis=-1, kind="stable")[:, :m]
        np.testing.assert_array_equal(pop._topm_prefix(keys, m), want)
        np.testing.assert_array_equal(
            pop._topm_prefix_rows(torch.as_tensor(keys), m).numpy(), want)


def test_device_kept_set_with_the_pivot_tied():
    """The M-th key ties with many keys on both sides of the cut: the kept
    ties are the lowest-index ones, whatever order topk returns them in."""
    keys = np.full((2, 1000), 5.0)
    keys[0, 900:] = 1.0                 # 100 strict keys, then 5.0 ties
    keys[1, ::2] = 9.0                  # 500 ties at the pivot 5.0
    for m in (100, 101, 150, 499):
        want = np.argsort(keys, axis=-1, kind="stable")[:, :m]
        np.testing.assert_array_equal(
            pop._topm_prefix_rows(torch.as_tensor(keys), m).numpy(), want)


# ---------------------------------------------------------------------- #
# PopulationState and scatter_finalize
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(4))
def test_scatter_finalize_bitwise_matches_dense(ref, seed):
    """Sparse K-sized writes into the N-wide state == the dense hybrid
    ``finalize_runs`` and the reference's ``scatter_finalize``, over rounds
    with empty cohorts and penalties; ``t - last_sel`` gives the dense ages
    exactly."""
    rng = np.random.default_rng(seed)
    R, N, K = 6, 50, 10
    cfg = FeelConfig(n_ues=K, population=N)
    dense = ctl.ControlState(
        policy_id=np.zeros(R, np.int32),
        sizes=rng.uniform(100, 3000, (R, N)),
        divs=rng.uniform(0, 1, (R, N)),
        r_min=rng.uniform(1e4, 1e7, (R, N)),
        reputations=rng.uniform(0, 1, (R, N)),
        ages=np.ones((R, N)), cfg=cfg)
    ps = pop.PopulationState.from_control(dense, t=0)
    ps_r = ref.pop.PopulationState.from_control(_ref_state(ref, dense), t=0)
    assert np.all(ps.last_sel == -1)
    for t in range(4):
        np.testing.assert_array_equal(ps.ages(t), dense.ages)
        sels, als, ats, pens = [], [], [], []
        for i in range(R):
            sel = rng.choice(N, size=rng.integers(0, K), replace=False)
            sels.append(sel)
            als.append(rng.uniform(0, 1, sel.size))
            ats.append(rng.uniform(0, 1, sel.size))
            pens.append(rng.uniform(0, 0.01, sel.size) if i % 2 else None)
        ctl.finalize_runs(dense, sels, als, ats, penalties=pens,
                          kernel="hybrid")
        pop.scatter_finalize(ps, t, sels, als, ats, penalties=pens)
        ref.pop.scatter_finalize(ps_r, t, sels, als, ats, penalties=pens)
        np.testing.assert_array_equal(ps.reputations, dense.reputations)
        np.testing.assert_array_equal(ps.reputations, ps_r.reputations)
        np.testing.assert_array_equal(ps.last_sel, ps_r.last_sel)
    np.testing.assert_array_equal(ps.ages(4), dense.ages)


def test_control_view_shares_buffers(ref):
    _, state, *_ = _instance(3, 6, 24)
    ps = pop.PopulationState.from_control(state, t=2)
    cv = ps.control_view(t=2)
    assert cv.reputations is ps.reputations and cv.sizes is ps.sizes
    assert cv.device == ps.device == state.device
    np.testing.assert_array_equal(cv.ages, state.ages)
    assert ps.n_population == 24 and ps.n_runs == state.n_runs
    ps_r = ref.pop.PopulationState.from_control(_ref_state(ref, state), t=2)
    assert ps.nbytes() == ps_r.nbytes() > 0
    assert pop.bytes_per_device(ps) == ref.pop.bytes_per_device(ps_r, 1)
    assert pop.bytes_per_device(ps, 2) == ref.pop.bytes_per_device(ps_r, 2)


def test_population_config_contract(ref):
    assert FeelConfig(n_ues=10).n_population == 10
    assert FeelConfig(n_ues=10, population=40).n_population == 40
    with pytest.raises(ValueError, match="population"):
        FeelConfig(n_ues=10, population=5).n_population
    for n in (1000, 40):
        cfg = FeelConfig(n_ues=10, population=n)
        assert pop.default_m(cfg) == ref.pop.default_m(
            ref.cfg.FeelConfig(n_ues=10, population=n))
    assert pop.default_m(FeelConfig(n_ues=10, population=1000)) == 80


_ONE_RANK_MESH = r"""
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.core import population as pop
from repro_torch.sharding.specs import MeshShape

assert pop.population_mesh(device_type="cpu") == MeshShape(
    ("data", "model"), (1, 1))
dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                        world_size=1)
try:
    mesh = pop.population_mesh(device_type="cpu")
    assert isinstance(mesh, DeviceMesh) and mesh.device_type == "cpu"
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    arr = np.arange(12.0).reshape(3, 4)
    ranks = np.arange(12).reshape(3, 4)
    a, b = pop.shard_population(mesh, arr, ranks)
    assert isinstance(a, DTensor) and isinstance(b, DTensor)
    assert list(a.placements) == [Shard(1), Replicate()]
    assert a.dtype == torch.float64 and b.dtype == torch.int64
    np.testing.assert_array_equal(a.full_tensor().numpy(), arr)
    np.testing.assert_array_equal(b.to_local().numpy(), ranks)
    one = pop.shard_population(mesh, arr)
    assert isinstance(one, DTensor)
    np.testing.assert_array_equal(one.full_tensor().numpy(), arr)
finally:
    dist.destroy_process_group()
print("OK")
"""


def test_one_device_mesh_helpers():
    """``population_mesh`` is the reference's ("data", "model") host mesh:
    a (1, 1) ``MeshShape`` without a process group, a ``DeviceMesh`` on a
    gloo group of one (a subprocess: the group is global to its process);
    ``shard_population`` places ``DTensor``s split over "data", dtypes
    kept."""
    r = subprocess.run([sys.executable, "-c", _ONE_RANK_MESH],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "PYTHONPATH": SRC})
    assert r.returncode == 0 and r.stdout.strip() == "OK", r.stderr[-3000:]


# ---------------------------------------------------------------------- #
# The population cut end to end
# ---------------------------------------------------------------------- #
KW = dict(n_train=2500, n_test=300, rounds=2, device="cpu")


def test_population_equal_k_is_the_legacy_regime():
    a = simulation.run_experiment(policy="dqs", seed=0, **KW)
    b = simulation.run_experiment(policy="dqs", seed=0, population=50, **KW)
    for f in ("acc", "malicious", "objective", "malicious_selected",
              "rep_gap"):
        assert a[f] == b[f], f


@pytest.fixture(scope="module")
def cut_runs(ref):
    """N = 120 candidates over 2,500 samples: the port's run, its sweep
    twin, the reference's run (initial params injected)."""
    task = ref_init_task()
    got, srv = run_recorded(simulation, policy="dqs", seed=0,
                            population=120, task=task, **KW)
    sweep = simulation.run_sweep(["dqs"], seeds=[0], population=120,
                                 tasks=[task], **KW)
    kw = {k: v for k, v in KW.items() if k != "device"}
    want, srv_r = run_recorded(ref.sim,
                               policy="dqs", seed=0, population=120, **kw)
    return got, srv, sweep, want, srv_r


def test_population_cut_matches_its_sweep_twin(cut_runs):
    got, srv, sweep, *_ = cut_runs
    assert np.isfinite(got["acc"]).all()
    assert srv.cfg.n_population == 120 and len(srv.clients) == 120
    assert sweep.select(policy="dqs", seed=0)[0]["acc"] == got["acc"]


def test_population_cut_matches_the_reference(cut_runs):
    got, srv, _, want, srv_r = cut_runs
    # the reference's own test size leaves some candidates without data
    assert any(c.size == 0 for c in srv.clients)
    assert [c.size for c in srv.clients] == [c.size for c in srv_r.clients]
    for log, rl in zip(srv.logs, srv_r.logs):
        np.testing.assert_array_equal(log.selected, rl.selected)
        assert log.forced == rl.forced
    assert got["malicious_selected"] == want["malicious_selected"]
    assert got["malicious"] == want["malicious"]
    np.testing.assert_allclose(got["acc"], want["acc"], atol=1e-2)
    np.testing.assert_allclose(got["objective"], want["objective"],
                               rtol=0, atol=1e-9)
    assert srv.rng.integers(1 << 31) == srv_r.rng.integers(1 << 31)


def test_population_sweep_through_the_device_layout(monkeypatch):
    """The sweep's stacked round schedules through the prefilter; forced
    onto the "device" layout on CPU tensors it gives the same runs."""
    policies = ["dqs", "best_channel"]
    want = simulation.run_sweep(policies, seeds=[0], population=120, **KW)
    real = pop.prefilter_schedule_runs
    calls = []

    def device_layout(*a, **k):
        calls.append(1)
        return real(*a, **dict(k, kernel="device"))

    monkeypatch.setattr(pop, "prefilter_schedule_runs", device_layout)
    got = simulation.run_sweep(policies, seeds=[0], population=120, **KW)
    assert len(calls) == KW["rounds"]
    for a, b in zip(got.runs, want.runs):
        for f in ("acc", "malicious_selected", "objective"):
            assert a[f] == b[f], f


def test_a_cohort_without_data_is_refused_like_the_reference(ref):
    """At 2,500 samples over 120 candidates, 70 hold no data. max_count
    packs the cheapest first, which are those (no training time), so its
    first cohort has no sample to average: the reference asserts, the port
    raises ValueError."""
    kw = {k: v for k, v in KW.items() if k != "device"}
    with pytest.raises(AssertionError, match="empty aggregation"):
        ref.sim.run_experiment(
            policy="max_count", seed=0, population=120, **kw)
    with pytest.raises(ValueError, match="empty aggregation"):
        simulation.run_experiment(policy="max_count", seed=0,
                                  population=120, **KW)
