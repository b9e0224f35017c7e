"""The port's batched multi-run sweep (``run_sweep``) against the JAX
package's and against its own sequential ``run_experiment`` — the
contracts of tests/test_sweep.py, at its size (K = 50, 3,000 / 400
samples, 4 rounds), on the CPU, with the reference's initial params
injected (``torch_parity.ref_init_task``).

Tolerances:

- against the port's own sequential runs (the same float32 data plane,
  rows trained in other groupings): tests/test_sweep.py's — ``acc``
  within 1e-7, ``source_acc`` and ``attack_success`` 1e-6 (a masked sum
  against a subset mean), ``rep_gap`` and the final reputations 1e-7,
  ``objective`` 1e-9; selections, ``malicious_selected``,
  ``recovery_rounds`` and the malicious sets exact;
- against the reference's ``run_sweep``: ``malicious_selected``,
  ``forced``, the defense counts and the malicious sets exact,
  ``objective`` within 1e-9; ``acc``, ``source_acc`` and
  ``attack_success`` within 1e-2, ``rep_gap`` 5e-2 (float32 products
  summed in another order, tests/test_torch_simulation.py); the LM's
  held-out loss within 1e-3.
"""
import warnings

import numpy as np
import pytest
import torch
from torch_parity import ref_init_task, reference, single_threaded  # noqa: F401

from repro_torch.configs.base import FeelConfig
from repro_torch.core.poisoning import EASY_PAIR
from repro_torch.federated.simulation import (SweepResult, averaged,
                                              run_experiment, run_sweep)
from repro_torch.kernels.robust_aggregate import robust_aggregate
from repro_torch.kernels.weighted_aggregate import weighted_aggregate

KW = dict(n_train=3000, n_test=400, rounds=4)
GRID = dict(policies=["dqs", "random"], seeds=[0, 1],
            attack_pairs=[EASY_PAIR])
EXACT = ("malicious_selected", "forced", "n_rejected", "n_clipped",
         "n_flagged", "malicious", "scenario", "defense", "task")


@pytest.fixture(scope="module")
def task():
    return ref_init_task()


@pytest.fixture(scope="module")
def sweep(task) -> SweepResult:
    before = (weighted_aggregate.launches, robust_aggregate.launches)
    res = run_sweep(tasks=[task], device="cpu", **GRID, **KW)
    res.launches = (weighted_aggregate.launches - before[0],
                    robust_aggregate.launches - before[1])
    return res


@pytest.fixture(scope="module")
def ref_sweep():
    return reference("federated.simulation").run_sweep(**GRID, **KW)


def check_against_reference(got_runs, want_runs, loss_tol=None):
    assert len(got_runs) == len(want_runs)
    for got, want in zip(got_runs, want_runs):
        for k in ("task", "policy", "seed", "scenario", "defense"):
            assert got[k] == want[k], k
        for f in EXACT:
            assert got[f] == want[f], f
        np.testing.assert_allclose(got["objective"], want["objective"],
                                   rtol=0, atol=1e-9)
        for f in ("acc", "source_acc", "attack_success"):
            np.testing.assert_allclose(got[f], want[f], atol=1e-2,
                                       err_msg=f)
        np.testing.assert_allclose(got["rep_gap"], want["rep_gap"],
                                   atol=5e-2)
        if loss_tol is not None:
            np.testing.assert_allclose(got["loss"], want["loss"],
                                       atol=loss_tol)


def check_against_sequential(run, seq):
    np.testing.assert_allclose(run["acc"], seq["acc"], atol=1e-7)
    for f in ("source_acc", "attack_success"):
        np.testing.assert_allclose(run[f], seq[f], atol=1e-6, err_msg=f)
    for f in ("rep_gap", "final_reputation_honest",
              "final_reputation_malicious"):
        np.testing.assert_allclose(run[f], seq[f], atol=1e-7, err_msg=f)
    np.testing.assert_allclose(run["objective"], seq["objective"],
                               atol=1e-9)
    for f in ("malicious_selected", "recovery_rounds", "malicious",
              "n_rejected", "n_flagged"):
        assert run[f] == seq[f], f


def test_sweep_matches_reference(sweep, ref_sweep):
    check_against_reference(sweep.runs, ref_sweep.runs)
    assert [r["round"] for r in sweep.rows] == \
        [r["round"] for r in ref_sweep.rows]


def test_sweep_matches_sequential_run_experiment(sweep, task):
    """Every run of the stacked sweep reproduces its sequential twin: the
    same RNG streams, schedules and curves."""
    for run in sweep.runs:
        check_against_sequential(run, run_experiment(
            run["policy"], run["attack_pair"], seed=run["seed"], task=task,
            device="cpu", **KW))


def test_stacked_matches_unstacked_sweep(sweep, task):
    """stack_runs=False (sequential execution, shared caches) is the
    oracle of the cross-run stacked path."""
    seq = run_sweep(tasks=[task], stack_runs=False, device="cpu", **GRID,
                    **KW)
    for a, b in zip(sweep.runs, seq.runs):
        assert (a["policy"], a["seed"]) == (b["policy"], b["seed"])
        np.testing.assert_allclose(a["acc"], b["acc"], atol=1e-7)
        assert a["malicious_selected"] == b["malicious_selected"]


def test_host_control_sweep_equals_batched(sweep, task):
    """control="host" (each run's numpy oracle) gives the same sweep as the
    batched control plane (tests/test_control.py's sweep contract)."""
    host = run_sweep(tasks=[task], control="host", device="cpu", **GRID,
                     **KW)
    for a, b in zip(sweep.runs, host.runs):
        np.testing.assert_array_equal(a["acc"], b["acc"])
        assert a["malicious_selected"] == b["malicious_selected"]
        assert a["forced"] == b["forced"]
        np.testing.assert_array_equal(a["objective"], b["objective"])
        assert (a["final_reputation_malicious"]
                == b["final_reputation_malicious"])


def test_sweep_tidy_table(sweep):
    """rows is one record per (policy, seed, round) with the per-round
    metrics; mean_curve reduces over seeds."""
    assert len(sweep.rows) == 2 * 2 * KW["rounds"]
    r0 = sweep.rows[0]
    for field in ("task", "policy", "seed", "scenario", "attack_pair",
                  "round", "acc", "loss", "source_acc", "attack_success",
                  "malicious_selected", "objective", "rep_gap", "forced"):
        assert field in r0, field
    curve = sweep.mean_curve("acc", policy="dqs")
    assert curve.shape == (KW["rounds"],)
    manual = np.mean([r["acc"] for r in sweep.runs
                      if r["policy"] == "dqs"], axis=0)
    np.testing.assert_allclose(curve, manual)
    assert len(sweep.select(policy="random", seed=1)) == 1
    with pytest.raises(KeyError):
        sweep.mean_curve("acc", policy="no_such_policy")


def test_partition_shared_across_policies(sweep):
    by_seed = {}
    for run in sweep.runs:
        by_seed.setdefault(run["seed"], []).append(run["malicious"])
    for mal_lists in by_seed.values():
        assert all(m == mal_lists[0] for m in mal_lists)


def test_sweep_rows_carry_defense_fields(sweep):
    r0 = sweep.rows[0]
    for field in ("defense", "n_clipped", "n_rejected", "n_flagged",
                  "det_precision", "det_recall"):
        assert field in r0, field
    assert r0["defense"] == "none"


def test_cpu_sweep_launches_no_kernel(sweep):
    assert sweep.launches == (0, 0)


def test_averaged_runs_on_sweep():
    out = averaged("dqs", EASY_PAIR, n_runs=2, device="cpu", **KW)
    assert len(out["acc"]) == KW["rounds"]
    assert len(out["malicious_selected"]) == KW["rounds"]
    assert np.isfinite(out["rep_gap"])


def test_sweep_loop_engine_falls_back():
    """engine='loop' executes sequentially but returns the same table."""
    kw = dict(n_train=3000, n_test=200, rounds=2, device="cpu")
    res = run_sweep(["dqs"], seeds=[0], attack_pairs=[EASY_PAIR],
                    engine="loop", **kw)
    assert len(res.rows) == 2
    ref = run_experiment("dqs", EASY_PAIR, seed=0, engine="loop", **kw)
    np.testing.assert_allclose(res.runs[0]["acc"], ref["acc"], atol=1e-7)


def test_mean_curve_nan_aware_watch_metrics():
    """NaN watch-metric rows — a watch-less scenario's attack_success —
    must not poison cross-run means, and all-NaN slices stay NaN without
    numpy's all-NaN RuntimeWarning."""
    res = run_sweep(["dqs"], seeds=[0], scenarios=["none", "flip_6to2"],
                    n_train=1200, n_test=300, rounds=2, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert np.isnan(res.mean_curve("attack_success",
                                       scenario="none")).all()
        mixed = res.mean_curve("attack_success")
        flip = res.mean_curve("attack_success", scenario="flip_6to2")
        np.testing.assert_allclose(mixed, flip)
        assert np.isfinite(mixed).all()
        out = res.averaged(scenario="none")
        assert np.isfinite(out["acc"]).all()
        assert np.isnan(out["attack_success"]).all()


# ---------------------------------------------------------------------- #
# A defended sweep and a two-task sweep against the reference
# ---------------------------------------------------------------------- #
SMALL = dict(n_train=1500, n_test=300, rounds=3)


def _small_cfg(config_class):
    return config_class(n_ues=10, n_malicious=2, min_selected=3)


def test_defended_sweep_matches_reference_and_sequential(task):
    grid = dict(policies=["dqs", "random"], seeds=[0],
                scenarios=["sign_flip"],
                defenses=["none", "trimmed_mean+validation", "median"],
                **SMALL)
    before = robust_aggregate.launches
    got = run_sweep(cfg=_small_cfg(FeelConfig), tasks=[task],
                    device="cpu", **grid)
    assert robust_aggregate.launches == before     # the CPU plain version
    want = reference("federated.simulation").run_sweep(
        cfg=_small_cfg(reference("configs.base").FeelConfig), **grid)
    check_against_reference(got.runs, want.runs)
    assert any(sum(r["n_flagged"]) for r in got.runs)
    for run in got.select(defense="trimmed_mean+validation"):
        check_against_sequential(run, run_experiment(
            run["policy"], seed=run["seed"], scenario="sign_flip",
            defense="trimmed_mean+validation", cfg=_small_cfg(FeelConfig),
            task=task, device="cpu", **SMALL))


def test_two_task_sweep_matches_reference():
    """mnist_mlp and lm_tiny in one sweep: one batched control plane over
    both tasks' runs, the cohorts batched per task."""
    grid = dict(policies=["dqs", "random"], seeds=[0],
                scenarios=["sign_flip"], n_train=960, n_test=240, rounds=2)
    got = run_sweep(cfg=FeelConfig(n_ues=8, n_malicious=2),
                    tasks=[ref_init_task("mnist_mlp"),
                           ref_init_task("lm_tiny")], device="cpu", **grid)
    want = reference("federated.simulation").run_sweep(
        cfg=reference("configs.base").FeelConfig(n_ues=8, n_malicious=2),
        tasks=["mnist_mlp", "lm_tiny"], **grid)
    check_against_reference(got.runs, want.runs, loss_tol=1e-3)
    lm = got.select(task="lm_tiny")
    assert len(lm) == 2 and all(np.isfinite(r["loss"]).all() for r in lm)
    assert all(np.isnan(r["loss"]).all()
               for r in got.select(task="mnist_mlp"))


# ---------------------------------------------------------------------- #
# What the sweep refuses
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("kw,err", [
    (dict(population=4), ValueError),          # fewer candidates than K
    (dict(cfg=dict(mode="async", async_latency_scale=-1.0)), ValueError),
    (dict(scenarios=["sign_flip"], lie_boost=0.2), ValueError),
    (dict(tasks=["mnist_mlp", "mnist_mlp"]), ValueError),
])
def test_run_sweep_rejects_what_the_port_does_not_run(kw, err):
    kw = dict(kw)
    cfg_kw = kw.pop("cfg", {})
    with pytest.raises(err):
        run_sweep(["dqs"], seeds=[0],
                  cfg=FeelConfig(n_ues=8, n_malicious=2, **cfg_kw),
                  n_train=600, n_test=100, rounds=1, device="cpu", **kw)


def test_run_sweep_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sweep(["dqs"], seeds=[0], cfg=FeelConfig(n_ues=4, n_malicious=0),
                  n_train=400, n_test=50, rounds=1)
