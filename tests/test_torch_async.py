"""The port's event-driven engine (federated/async_engine.py) and its CLI
(launch/serve.py), against the port's synchronous engine and against the
JAX package's async runs.

Tolerances, as tests/test_async.py holds the reference's:

- zero-latency parity: ``mode="async"`` at ``async_latency_scale=0.0``
  with wave triggers is bit-equal to ``mode="sync"`` on ``acc``, ``loss``,
  ``rep_gap``, ``objective`` and ``malicious_selected``, on MNIST under
  both control planes, on ``lm_tiny``, on the loop engine and with
  ``channel_corr``;
- against the reference's same run, its initial params injected: the
  per-aggregation selections, ``malicious_selected``, ``trigger``,
  ``n_uploads``, ``mean_age`` and ``sim_time`` exact (the simulated clock
  is host float64 on the same draws and bandwidth splits), ``acc`` within
  1e-2 and ``rep_gap`` within 5e-2 (tests/test_torch_simulation.py's),
  ``loss`` within 1e-3 (tests/test_torch_lm_task.py's);
- the buffer, deadline and wave triggers; the async sweep matrix; the CLI
  in JSON and table form, with ``--trace``, and as ``python -m``.
"""
import io
import json
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
from torch_parity import (ref_init_task, reference, run_recorded,  # noqa: F401
                          single_threaded)

from repro_torch.configs.base import FeelConfig
from repro_torch.data.partition import partition
from repro_torch.data.synthetic_mnist import generate
from repro_torch.federated import simulation
from repro_torch.federated.async_engine import AsyncFeelEngine
from repro_torch.federated.server import FeelServer
from repro_torch.launch import serve
from repro_torch.obs import report as obs_report
from repro_torch.obs import trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(n_ues=10, n_malicious=2, min_selected=3, rounds=3)
KW = dict(n_train=1500, n_test=300, seed=0)
LM_KW = dict(n_train=960, n_test=240, seed=0)
PARITY_FIELDS = ("acc", "loss", "rep_gap", "objective",
                 "malicious_selected")
ASYNC_FIELDS = ("trigger", "n_uploads", "mean_age", "sim_time")


def _zero_latency(**over):
    return dict(over, mode="async", async_buffer=None, async_deadline=None,
                async_latency_scale=0.0)


def _port(cfg, task="mnist_mlp", **kw):
    """The port's run on the CPU with the reference's initial params:
    (result, server)."""
    return run_recorded(simulation, cfg=FeelConfig(**cfg),
                        task=ref_init_task(task), device="cpu", **kw)


@pytest.fixture(scope="module")
def ref():
    """The reference's modules these tests run, imported on demand."""
    return types.SimpleNamespace(
        sim=reference("federated.simulation"), cfg=reference("configs.base"),
        serve=reference("launch.serve"))


def _ref(ref, cfg, task="mnist_mlp", **kw):
    return run_recorded(ref.sim, cfg=ref.cfg.FeelConfig(**cfg), task=task,
                        **kw)


def _assert_parity(sync, azero):
    for f in PARITY_FIELDS:
        a = np.asarray(sync[f], float)
        b = np.asarray(azero[f], float)
        # equal_nan: the MNIST task has no loss metric
        assert np.array_equal(a, b, equal_nan=True), (f, sync[f], azero[f])


def _assert_matches_reference(got, want, loss_tol=None):
    (out, srv), (out_r, srv_r) = got, want
    assert len(srv.logs) == len(srv_r.logs)
    for log, rl in zip(srv.logs, srv_r.logs):
        np.testing.assert_array_equal(log.selected, rl.selected)
        assert log.forced == rl.forced
    for f in ("malicious_selected", "malicious", "scenario", "defense",
              *ASYNC_FIELDS):
        assert out.get(f) == out_r.get(f), f
    np.testing.assert_allclose(out["acc"], out_r["acc"], atol=1e-2)
    np.testing.assert_allclose(out["rep_gap"], out_r["rep_gap"], atol=5e-2)
    if loss_tol is not None:
        np.testing.assert_allclose(out["loss"], out_r["loss"],
                                   atol=loss_tol)
    assert srv.rng.integers(1 << 31) == srv_r.rng.integers(1 << 31)


# ---------------------------------------------------------------------- #
# Zero-latency parity with the synchronous engine
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("control", ["batched", "host"])
def test_zero_latency_parity_mnist(ref, control):
    kw = dict(KW, scenario="flip_6to2", control=control)
    sync = _port(CFG, **kw)
    azero = _port(_zero_latency(**CFG), **kw)
    _assert_parity(sync[0], azero[0])
    assert azero[0]["sim_time"] == [0.0] * CFG["rounds"]
    assert azero[0]["trigger"] == ["wave"] * CFG["rounds"]
    assert "sim_time" not in sync[0]
    _assert_matches_reference(azero, _ref(ref, _zero_latency(**CFG), **kw))


@pytest.mark.parametrize("control", ["batched", "host"])
def test_zero_latency_parity_lm(ref, control):
    cfg = dict(CFG, rounds=2)
    kw = dict(LM_KW, task="lm_tiny", control=control,
              scenario="token_flip_1to5")
    sync = _port(cfg, **kw)
    azero = _port(_zero_latency(**cfg), **kw)
    _assert_parity(sync[0], azero[0])
    assert np.isfinite(azero[0]["loss"]).all()
    _assert_matches_reference(azero, _ref(ref, _zero_latency(**cfg), **kw),
                              loss_tol=1e-3)


def test_zero_latency_parity_loop_engine(ref):
    kw = dict(KW, scenario="stale_rider_2", engine="loop")
    sync = _port(CFG, **kw)
    azero = _port(_zero_latency(**CFG), **kw)
    _assert_parity(sync[0], azero[0])
    _assert_matches_reference(azero, _ref(ref, _zero_latency(**CFG), **kw))


def test_zero_latency_parity_with_channel_corr():
    """The AR(1) channel state is mode-independent: sync and zero-latency
    async see the same correlated draws."""
    cfg = dict(CFG, channel_corr=0.4)
    kw = dict(KW, scenario="flip_6to2")
    _assert_parity(_port(cfg, **kw)[0], _port(_zero_latency(**cfg), **kw)[0])


def test_engine_and_server_refuse_the_wrong_mode():
    train, test = generate(800, 100, seed=0)
    rng = np.random.default_rng(0)
    clients = partition(train, 4, rng)
    sync = FeelServer(FeelConfig(n_ues=4, n_malicious=0), clients, test,
                      rng, device="cpu")
    with pytest.raises(ValueError, match="mode"):
        AsyncFeelEngine(sync)
    srv = FeelServer(FeelConfig(n_ues=4, n_malicious=0, mode="async"),
                     clients, test, rng, device="cpu")
    with pytest.raises(ValueError, match="AsyncFeelEngine"):
        srv.run(1)
    assert srv.logs == []


# ---------------------------------------------------------------------- #
# Triggers
# ---------------------------------------------------------------------- #
def test_buffer_trigger_sizes_and_ages(ref):
    cfg = dict(CFG, mode="async", async_buffer=2, async_staleness=0.5,
               channel_corr=0.3, rounds=5)
    kw = dict(KW, scenario="stale_rider_2")
    got = _port(cfg, **kw)
    r = got[0]
    assert len(r["acc"]) == 5
    assert np.isfinite(np.asarray(r["acc"], float)).all()
    assert np.isfinite(np.asarray(r["rep_gap"], float)).all()
    st = np.asarray(r["sim_time"], float)
    assert np.all(np.diff(st) >= 0) and st[-1] > 0
    for trig, n in zip(r["trigger"], r["n_uploads"]):
        if trig == "buffer":
            assert n == 2
    assert max(r["mean_age"]) > 0       # stragglers age
    _assert_matches_reference(got, _ref(ref, cfg, **kw))


def test_deadline_trigger_fires(ref):
    cfg = dict(CFG, mode="async", async_deadline=20.0, rounds=4)
    kw = dict(KW, scenario="flip_6to2")
    got = _port(cfg, **kw)
    assert len(got[0]["acc"]) == 4
    assert "deadline" in got[0]["trigger"], got[0]["trigger"]
    assert np.isfinite(np.asarray(got[0]["acc"], float)).all()
    _assert_matches_reference(got, _ref(ref, cfg, **kw))


def test_wave_trigger_is_the_sync_limit_shape(ref):
    """buffer=None waits for the whole wave: n_uploads is the wave's size
    and every age 0, even at full latency."""
    cfg = dict(CFG, mode="async")
    kw = dict(KW, scenario="flip_6to2")
    got = _port(cfg, **kw)
    r = got[0]
    assert r["trigger"] == ["wave"] * 3 and r["mean_age"] == [0.0] * 3
    assert np.all(np.diff(np.asarray(r["sim_time"], float)) > 0)
    assert r["n_uploads"] == [log.selected.size for log in got[1].logs]
    _assert_matches_reference(got, _ref(ref, cfg, **kw))


# ---------------------------------------------------------------------- #
# The sweep and the CLI
# ---------------------------------------------------------------------- #
def test_async_sweep_matrix(ref):
    """The (scenario x defense x policy) grid runs on async, one event loop
    a run on the shared caches, each run as the reference's."""
    cfg = dict(CFG, mode="async", async_buffer=3, channel_corr=0.3,
               rounds=2)
    kw = dict(seeds=[0], scenarios=["none", "stale_rider_2"],
              defenses=["none", "trimmed_mean"], n_train=KW["n_train"],
              n_test=KW["n_test"])
    got = simulation.run_sweep(["dqs"], cfg=FeelConfig(**cfg),
                               tasks=[ref_init_task()], device="cpu", **kw)
    want = ref.sim.run_sweep(["dqs"], cfg=ref.cfg.FeelConfig(**cfg), **kw)
    assert len(got.runs) == len(want.runs) == 4
    for a, b in zip(got.runs, want.runs):
        for f in ("scenario", "defense", "malicious_selected", "n_rejected",
                  "forced"):
            assert a[f] == b[f], f
        assert len(a["acc"]) == 2 and np.isfinite(a["acc"]).all()
        np.testing.assert_allclose(a["acc"], b["acc"], atol=1e-2)


def test_serve_cli_json(ref, capsys):
    argv = ["--rounds", "2", "--ues", "10", "--malicious", "2",
            "--n-train", "1500", "--n-test", "300", "--buffer", "4",
            "--channel-corr", "0.3", "--json"]
    assert serve.main(argv + ["--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert len(res["acc"]) == 2 and len(res["sim_time"]) == 2
    assert res["scenario"] == "none"
    ref.serve.main(argv)
    want = json.loads(capsys.readouterr().out)
    for f in ("malicious_selected", *ASYNC_FIELDS):
        assert res[f] == want[f], f


def test_serve_cli_table_output(capsys):
    assert serve.main(["--rounds", "1", "--ues", "10", "--malicious", "2",
                       "--n-train", "1500", "--n-test", "300",
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "version,sim_s,acc,trigger,n_uploads,mean_age" in out
    assert serve.main(["--rounds", "1", "--ues", "10", "--malicious", "2",
                       "--n-train", "1500", "--n-test", "300", "--sync",
                       "--device", "cpu"]) == 0
    assert "round,acc" in capsys.readouterr().out


def test_serve_cli_writes_a_trace(tmp_path, capsys):
    """``--trace PATH`` writes the run's JSONL trace: the async spans carry
    both clocks, and the report renders it."""
    path = str(tmp_path / "serve.jsonl")
    try:
        assert serve.main(["--rounds", "2", "--ues", "10", "--malicious",
                           "2", "--n-train", "1500", "--n-test", "300",
                           "--buffer", "4", "--trace", path,
                           "--device", "cpu"]) == 0
    finally:
        trace.configure(enabled=False)
    capsys.readouterr()
    meta, spans, metrics = trace.load_jsonl(path)
    assert meta["kind"] == "meta" and meta["torch"]
    names = {s["name"] for s in spans}
    assert {"experiment", "async.dispatch", "async.aggregate"} <= names
    for s in spans:
        assert s["t1"] >= s["t0"]
        if s["name"] != "experiment":      # every span of the event loop
            assert s["sim_t1"] >= s["sim_t0"] >= 0.0, s
    aggs = [s for s in spans if s["name"] == "async.aggregate"]
    assert len(aggs) == 2 and aggs[-1]["sim_t1"] > 0.0
    assert metrics["observations"]["async.upload_age"]["count"] == 8
    rep = obs_report.summarize(path)
    assert rep["phases"]["async.aggregate"]["count"] == 2
    out = io.StringIO()
    obs_report.render(rep, out=out)
    assert "async.dispatch," in out.getvalue()
    assert "roofline,train," in out.getvalue()


def test_serve_runs_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--rounds", "1",
         "--ues", "6", "--malicious", "1", "--n-train", "900",
         "--n-test", "200", "--device", "cpu", "--json"],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=300)
    res = json.loads(out.stdout)
    assert len(res["acc"]) == 1 and res["trigger"] == ["wave"]
