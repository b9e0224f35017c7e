"""The slice as a whole: the port's ``run_experiment`` against the
reference's ``run_experiment(..., control="host")`` under the attack
scenarios that reach the server (model and report attacks), undefended, on
the reference matrix's config (K = 8, 2 malicious, n_train 1,200, n_test
300), with the reference's initial params injected through
``torch_parity.ref_init_task``. The defended runs are in
tests/test_torch_simulation_defenses.py.

Exact: per-round selections, ``malicious_selected``, the defense counts,
``recovery_rounds`` and the host RNG's next draw. Within tolerance, as in
tests/test_torch_server.py: ``acc``, ``source_acc`` and ``attack_success``
1e-2, ``rep_gap`` 5e-2 (float32 products summed in another order move the
accuracy curve by up to ~2e-3 with the selections unchanged). Inside the
port, the loop and vectorized engines agree within 1e-5, as
tests/test_defenses.py holds the reference's.
"""
import numpy as np
import pytest
import torch
from torch_parity import (ref_init_task, reference, run_recorded,  # noqa: F401
                          single_threaded)

from repro_torch.configs.base import FeelConfig
from repro_torch.federated import simulation
from repro_torch.kernels.robust_aggregate import robust_aggregate
from repro_torch.kernels.weighted_aggregate import weighted_aggregate

KW = dict(n_train=1200, n_test=300, rounds=2, policy="dqs")
SCENARIOS = ["sign_flip", "boost_3", "free_rider", "stale_rider_2",
             "lying_flip_8to4"]
EXACT = ("malicious_selected", "n_rejected", "n_clipped", "n_flagged",
         "recovery_rounds", "scenario", "defense", "malicious")


def _cfg(mod):
    return mod.FeelConfig(n_ues=8, n_malicious=2, min_selected=3)


def run_triple(seed=0, **kw):
    """{"ref": reference vectorized/host run, "vectorized"/"loop": the
    port's on the CPU}, each as (result dict, server); plus the kernel
    launches of the port's runs."""
    kw = dict(seed=seed, **kw)
    sim_r = reference("federated.simulation")
    cfg_r = _cfg(reference("configs.base"))
    out = {"ref": run_recorded(sim_r, cfg=cfg_r, engine="vectorized",
                               control="host", **KW, **kw)}
    before = (weighted_aggregate.launches, robust_aggregate.launches)
    task = ref_init_task()
    for engine in ("vectorized", "loop"):
        out[engine] = run_recorded(simulation, cfg=_cfg(simulation),
                                   engine=engine, task=task, device="cpu",
                                   **KW, **kw)
    out["launches"] = (weighted_aggregate.launches - before[0],
                       robust_aggregate.launches - before[1])
    return out


def check_against_reference(out):
    (want, srv_r), (got, srv) = out["ref"], out["vectorized"]
    assert len(srv.logs) == len(srv_r.logs) == KW["rounds"]
    for log, rl in zip(srv.logs, srv_r.logs):
        np.testing.assert_array_equal(log.selected, rl.selected)
        assert log.forced == rl.forced
    for f in EXACT:
        assert got[f] == want[f], f
    for f in ("det_precision", "det_recall"):
        np.testing.assert_array_equal(got[f], want[f])
    assert srv.rng.integers(1 << 31) == srv_r.rng.integers(1 << 31)
    for f in ("acc", "source_acc", "attack_success"):
        np.testing.assert_allclose(got[f], want[f], atol=1e-2, err_msg=f)
    np.testing.assert_allclose(got["rep_gap"], want["rep_gap"], atol=5e-2)


def check_engines_agree(out):
    (vec, srv_v), (loop, srv_l) = out["vectorized"], out["loop"]
    for a, b in zip(srv_v.logs, srv_l.logs):
        np.testing.assert_array_equal(a.selected, b.selected)
    for f in EXACT:
        assert vec[f] == loop[f], f
    for f in ("acc", "source_acc", "attack_success", "rep_gap"):
        np.testing.assert_allclose(vec[f], loop[f], atol=1e-5, err_msg=f)


@pytest.fixture(scope="module")
def scenario_runs():
    return {}


def _runs(cache, name):
    if name not in cache:
        cache[name] = run_triple(scenario=name)
    return cache[name]


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_matches_reference(scenario_runs, name):
    out = _runs(scenario_runs, name)
    check_against_reference(out)
    assert any(out["vectorized"][0]["malicious_selected"])


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_engines_agree(scenario_runs, name):
    check_engines_agree(_runs(scenario_runs, name))


def test_cpu_runs_launch_no_kernel(scenario_runs):
    assert _runs(scenario_runs, "sign_flip")["launches"] == (0, 0)


def test_result_dict_has_the_reference_keys(scenario_runs):
    out = _runs(scenario_runs, "lying_flip_8to4")
    assert sorted(out["vectorized"][0]) == sorted(out["ref"][0])
    assert out["vectorized"][0]["scenario"] == "lying_flip_8to4"


@pytest.mark.parametrize("kw,err", [
    (dict(control="jax"), ValueError),
    (dict(population=4), ValueError),          # fewer candidates than K
    (dict(cfg=dict(mode="async", async_buffer=0)), ValueError),
    (dict(defense="no_such_defense"), KeyError),
    (dict(scenario="no_such_scenario"), KeyError),
    (dict(scenario="token_noise_0.3"), TypeError),
])
def test_run_experiment_rejects_what_the_port_does_not_run(kw, err):
    kw = dict(kw)
    cfg_kw = kw.pop("cfg", {})
    with pytest.raises(err):
        simulation.run_experiment(
            cfg=FeelConfig(n_ues=8, n_malicious=2, **cfg_kw), n_train=600,
            n_test=100, rounds=1, device="cpu", **kw)


def test_run_experiment_without_device_raises_when_cuda_is_absent(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulation.run_experiment(cfg=FeelConfig(n_ues=4, n_malicious=0),
                                  n_train=400, n_test=50, rounds=1)
