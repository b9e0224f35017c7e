"""The LM slice as a whole: ``LmTask`` (``lm_tiny``) and
``run_experiment(task="lm_tiny")`` against the JAX package, on the CPU.

The run is tests/test_task_lm.py's ``LM_KW`` (K = 8, 2 malicious, 960/240
windows, 2 rounds) under ``token_flip_1to5`` and ``token_noise_0.3``: the
reference's vectorized run on the host control plane against the port's
two engines, with the reference's initial params injected through
``torch_parity.ref_init_task("lm_tiny")``. Exact: per-round selections,
``malicious_selected``, the host RNG's next draw. Within tolerance: the
unit accuracies (``acc``, ``source_acc``, ``attack_success``) 1e-2 and the
held-out cross-entropy (``loss``) 1e-3 — float32 products summed in
another order move a few greedy predictions. The port's loop and
vectorized engines agree within 1e-5.
"""
import numpy as np
import pytest
import torch
from torch_parity import (ref_init_task, reference, run_recorded,  # noqa: F401
                          single_threaded)

from repro_torch.configs.base import FeelConfig
from repro_torch.core.attacks import as_scenario
from repro_torch.core.poisoning import pick_malicious
from repro_torch.federated import simulation
from repro_torch.federated.server import build_cohort_data
from repro_torch.federated.task import (LM_TINY, TASKS, LmTask, MnistTask,
                                        as_task)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.robust_aggregate import robust_aggregate
from repro_torch.kernels.weighted_aggregate import weighted_aggregate

LM_KW = dict(task="lm_tiny", n_train=960, n_test=240, rounds=2)
SCENARIOS = ["token_flip_1to5", "token_noise_0.3"]
EXACT = ("malicious_selected", "scenario", "defense", "malicious",
         "recovery_rounds", "task")
LAUNCHES = (weighted_aggregate, robust_aggregate, flash_attention)


def _cfg(mod):
    return mod.FeelConfig(n_ues=8, n_malicious=2)


# ---------------------------------------------------------------------- #
# The task
# ---------------------------------------------------------------------- #
def test_task_registry():
    assert as_task("mnist_mlp") is as_task("mnist_mlp") is TASKS["mnist_mlp"]
    lm = as_task("lm_tiny")
    assert isinstance(lm, LmTask) and lm.n_symbols == LM_TINY.vocab_size
    assert as_task(lm) is lm and isinstance(as_task(MnistTask()), MnistTask)
    with pytest.raises(KeyError):
        as_task("nope")
    with pytest.raises(TypeError):
        as_task(7)
    assert hash(as_task("lm_tiny")) == hash(LmTask())


def test_lm_task_host_plane_matches_the_reference():
    """Data, partition under a token attack, the metadata a UE reports and
    the eval units: equal to the reference's, byte for byte."""
    tsk, rtsk = as_task("lm_tiny"), reference("federated.task").as_task(
        "lm_tiny")
    atk_r = reference("core.attacks")
    train, test = tsk.generate_data(480, 120, seed=3)
    train_r, test_r = rtsk.generate_data(480, 120, seed=3)
    for a, b in ((train, train_r), (test, test_r)):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.y, b.y)
    rng, rng_r = np.random.default_rng(5), np.random.default_rng(5)
    mal = pick_malicious(6, 2, rng)
    mal_r = pick_malicious(6, 2, rng_r)
    clients = tsk.partition_clients(train, 6, rng, mal,
                                    as_scenario("token_flip_1to5").data)
    clients_r = rtsk.partition_clients(
        train_r, 6, rng_r, mal_r, atk_r.as_scenario("token_flip_1to5").data)
    assert rng.integers(1 << 31) == rng_r.integers(1 << 31)
    for c, cr in zip(clients, clients_r):
        assert (c.ue_id, c.malicious, c.size) == (cr.ue_id, cr.malicious,
                                                  cr.size)
        np.testing.assert_array_equal(c.data.tokens, cr.data.tokens)
        np.testing.assert_array_equal(tsk.histogram(c.data),
                                      rtsk.histogram(cr.data))
        assert tsk.gini(c.data) == rtsk.gini(cr.data)
    np.testing.assert_array_equal(tsk.unit_labels(test),
                                  rtsk.unit_labels(test_r))
    np.testing.assert_array_equal(tsk.unit_rows(test),
                                  rtsk.unit_rows(test_r))
    ei = tsk.eval_inputs(test, "cpu")["tokens"]
    assert ei.dtype == torch.int64
    np.testing.assert_array_equal(ei.numpy(), test.tokens)
    np.testing.assert_array_equal(tsk.unit_targets(test, "cpu").numpy(),
                                  np.asarray(rtsk.unit_targets(test_r)))


def test_build_cohort_data_casts_integer_fields_to_int64():
    tsk = as_task("lm_tiny")
    train, test = tsk.generate_data(480, 60, seed=0)
    clients = tsk.partition_clients(train, 4, np.random.default_rng(0))
    masks = np.ones((4, len(tsk.unit_labels(test))), np.float32)
    cd = build_cohort_data(clients, masks, "cpu", batch_size=tsk.batch_size)
    for bkt in cd.buckets:
        assert sorted(bkt["data"]) == ["tokens"]
        toks = bkt["data"]["tokens"]
        assert toks.dtype == torch.int64 and toks.shape[-1] == tsk.seq
        assert bkt["mask"].shape == toks.shape[:2]
    mt = as_task("mnist_mlp")
    tr, te = mt.generate_data(600, 50, seed=0)
    cl = mt.partition_clients(tr, 3, np.random.default_rng(0))
    cd = build_cohort_data(cl, np.ones((3, 50), np.float32), "cpu")
    data = cd.buckets[0]["data"]
    assert (data["x"].dtype, data["y"].dtype) == (torch.float32, torch.int64)


# ---------------------------------------------------------------------- #
# run_experiment against the reference
# ---------------------------------------------------------------------- #
def run_triple(scenario, seed=0):
    """{"ref": the reference's vectorized/host run, "vectorized"/"loop":
    the port's on the CPU} as (result dict, server), and the kernel
    launches of the port's runs."""
    sim_r = reference("federated.simulation")
    out = {"ref": run_recorded(sim_r, cfg=_cfg(reference("configs.base")),
                               seed=seed, scenario=scenario,
                               engine="vectorized", control="host", **LM_KW)}
    before = [fn.launches for fn in LAUNCHES]
    kw = dict(LM_KW, task=ref_init_task("lm_tiny"))
    for engine in ("vectorized", "loop"):
        out[engine] = run_recorded(simulation, cfg=_cfg(simulation),
                                   seed=seed, scenario=scenario,
                                   engine=engine, device="cpu", **kw)
    out["launches"] = [fn.launches - b for fn, b in zip(LAUNCHES, before)]
    return out


@pytest.fixture(scope="module")
def runs():
    return {}


def _runs(cache, name):
    if name not in cache:
        cache[name] = run_triple(name)
    return cache[name]


@pytest.mark.parametrize("name", SCENARIOS)
def test_run_experiment_matches_the_reference(runs, name):
    out = _runs(runs, name)
    (want, srv_r), (got, srv) = out["ref"], out["vectorized"]
    assert len(srv.logs) == len(srv_r.logs) == LM_KW["rounds"]
    for log, rl in zip(srv.logs, srv_r.logs):
        np.testing.assert_array_equal(log.selected, rl.selected)
        assert log.forced == rl.forced
    for f in EXACT:
        assert got[f] == want[f], f
    assert srv.rng.integers(1 << 31) == srv_r.rng.integers(1 << 31)
    for f in ("acc", "source_acc", "attack_success"):
        np.testing.assert_allclose(got[f], want[f], atol=1e-2, err_msg=f)
    np.testing.assert_allclose(got["loss"], want["loss"], atol=1e-3)
    assert all(np.isfinite(got["loss"])) and got["loss"][1] < got["loss"][0]
    assert any(got["malicious_selected"])


@pytest.mark.parametrize("name", SCENARIOS)
def test_engines_agree(runs, name):
    out = _runs(runs, name)
    (vec, srv_v), (loop, srv_l) = out["vectorized"], out["loop"]
    for a, b in zip(srv_v.logs, srv_l.logs):
        np.testing.assert_array_equal(a.selected, b.selected)
    for f in EXACT:
        assert vec[f] == loop[f], f
    for f in ("acc", "loss", "source_acc", "attack_success", "rep_gap"):
        np.testing.assert_allclose(vec[f], loop[f], atol=1e-5, err_msg=f)


def test_cpu_runs_launch_no_kernel(runs):
    assert _runs(runs, "token_flip_1to5")["launches"] == [0, 0, 0]


def test_result_dict_has_the_reference_keys(runs):
    out = _runs(runs, "token_noise_0.3")
    assert sorted(out["vectorized"][0]) == sorted(out["ref"][0])
    assert out["vectorized"][0]["task"] == "lm_tiny"


def test_run_experiment_takes_the_task_defaults(monkeypatch):
    """n_train/n_test, the learning rate and the batch size default to the
    LM task's protocol values, as in the reference."""
    seen = {}
    real_data, real_server = LmTask.generate_data, simulation.FeelServer

    def data_spy(self, n_train, n_test, seed):
        seen.update(n_train=n_train, n_test=n_test)
        return real_data(self, n_train, n_test, seed)

    def server_spy(*args, **kw):
        srv = real_server(*args, **kw)
        seen.update(lr=srv.lr, batch_size=srv.batch_size)
        raise StopIteration

    monkeypatch.setattr(LmTask, "generate_data", data_spy)
    monkeypatch.setattr(simulation, "FeelServer", server_spy)
    with pytest.raises(StopIteration):
        simulation.run_experiment(cfg=FeelConfig(n_ues=4, n_malicious=0),
                                  task="lm_tiny", device="cpu")
    assert seen == dict(n_train=2000, n_test=400, lr=0.3, batch_size=8)


def test_lm_run_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulation.run_experiment(cfg=FeelConfig(n_ues=4, n_malicious=0),
                                  task="lm_tiny", n_train=200, n_test=20,
                                  rounds=1)
