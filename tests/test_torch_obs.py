"""The port's observability plane (src/repro_torch/obs/, launch/roofline.py)
against the JAX package's (src/repro/obs/) and against itself.

1. Unit parity with ``repro.obs``: the same span dicts and metric updates
   through both packages' ``phase_summary``, ``to_trace_event``,
   ``MetricRegistry.snapshot``, ``report.summarize`` and ``report.render``
   give equal output, apart from the header and comment lines and the
   roofline constants (the reference's set to the H100's for the
   comparison).
2. The contract cases of tests/test_obs.py on the port: the disabled path
   is the shared ``NULL_SPAN`` with an empty ring and no allocation,
   ``traced`` passes through, spans nest, async spans carry both clocks,
   the sinks round-trip, ``configure`` resets, the report runs as
   ``python -m``, and the kernel-build probe marks the span that loaded a
   kernel.
3. Zero semantic footprint: tracing on is bit-equal to tracing off —
   results, selections, params (``torch.equal``), the host RNG state and
   the simulated clock — over engine x control x mode on ``mnist_mlp``,
   ``lm_tiny``, a population cut and a sweep.
4. Span-tree parity with the reference's traced ``run_experiment`` (its
   initial params injected): the same span names, ids, parents, depths and
   attributes, the simulated clock stamps equal, the same counters,
   observations and gauges. Left out: the wall-clock fields, ``compiled``
   (the reference's marks a jit compile, the port's a kernel build, which
   the CPU never does) and the end-of-run gauges ``compile.*`` (the
   reference's jit cache sizes) and ``launches.*`` (the port's
   counterpart). No structural difference exists: every case's tree is
   the reference's span for span.
5. Tracing adds no host read of a tensor: the calls of ``Tensor.item``,
   ``tolist``, ``cpu``, ``numpy``, ``__float__``, ``__int__``,
   ``__bool__`` and ``torch.cuda.synchronize`` over a run are the same
   with tracing on and off.
"""
import collections
import dataclasses
import functools
import io
import json
import pathlib
import subprocess
import sys
import tracemalloc
import types

import numpy as np
import pytest
import torch
from torch_parity import (ref_init_task, reference, run_recorded,  # noqa: F401
                          single_threaded)

from repro_torch.configs import registry
from repro_torch.configs.base import FeelConfig
from repro_torch.federated import server as server_mod
from repro_torch.federated import simulation
from repro_torch.kernels import build
from repro_torch.launch import mesh, roofline
from repro_torch.obs import report as obs_report
from repro_torch.obs import trace
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.obs.trace import NULL_SPAN

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(n_ues=10, n_malicious=2, min_selected=3)
KW = dict(n_train=1500, n_test=300, seed=0, rounds=2)
LM_KW = dict(n_train=960, n_test=240, seed=0, rounds=2)
WALL = ("t0", "t1", "dur")
SIM = ("sim_t0", "sim_t1")


@pytest.fixture(autouse=True)
def _tracer_off_after():
    """Every test leaves the port's tracer disabled and empty, the default
    the rest of the suite runs under."""
    yield
    trace.configure(enabled=False)


@pytest.fixture(scope="module")
def ref():
    """The reference's modules, imported on demand, its tracer left off."""
    ns = types.SimpleNamespace(
        trace=reference("obs.trace"), metrics=reference("obs.metrics"),
        report=reference("obs.report"), roofline=reference("launch.roofline"),
        sim=reference("federated.simulation"), cfg=reference("configs.base"),
        registry=reference("configs.registry"))
    yield ns
    ns.trace.configure(enabled=False)


@pytest.fixture
def h100_ref(ref, monkeypatch):
    """The reference's roofline with the H100's constants."""
    monkeypatch.setattr(ref.roofline, "PEAK_FLOPS_BF16", mesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(ref.roofline, "HBM_BW", mesh.HBM_BW)
    monkeypatch.setattr(ref.roofline, "ICI_BW", mesh.ICI_BW)
    return ref


def _port_run(cfg=None, task="mnist_mlp", **kw):
    """The port's run on the CPU, the reference's initial params injected:
    (result, server)."""
    return run_recorded(simulation, cfg=FeelConfig(**(cfg or CFG)),
                        task=ref_init_task(task), device="cpu", **kw)


def _traced(fn, tracer_mod=trace):
    """``fn()`` with ``tracer_mod``'s tracer on: (its result, the spans,
    the metric snapshot)."""
    tracer_mod.configure(enabled=True)
    try:
        out = fn()
        return (out, list(tracer_mod.tracer().spans),
                tracer_mod.tracer().metrics.snapshot())
    finally:
        tracer_mod.configure(enabled=False)


# ---------------------------------------------------------------------- #
# 1. unit parity with repro.obs
# ---------------------------------------------------------------------- #
NAMES = ("round", "schedule", "schedule.pack", "train", "train.bucket",
         "eval", "defense.aggregate", "async.dispatch", "async.aggregate")


def _span_dicts(n=60):
    """Span records as ``load_jsonl`` returns them: ragged durations, some
    with analytic estimates, a compile flag or the simulated clock."""
    rng = np.random.default_rng(7)
    recs, t = [], 10.0
    for i in range(n):
        dur = float(rng.exponential(0.01))
        r = {"kind": "span", "name": NAMES[i % len(NAMES)], "sid": i,
             "parent": -1, "depth": 0, "t0": t, "t1": t + dur, "dur": dur}
        if r["name"] in ("schedule", "train"):
            r["attrs"] = {"t": i, "est_flops": float(rng.uniform(1e3, 1e9)),
                          "est_bytes": float(rng.uniform(1e3, 1e8))}
        elif r["name"] == "train.bucket":
            r["attrs"] = {"rows": 8, "compiled": bool(i < 20)}
        if r["name"].startswith("async"):
            r["sim_t0"], r["sim_t1"] = t * 3.0, t * 3.0 + dur
        recs.append(r)
        t += dur * float(rng.uniform(0.5, 1.5))
    return recs


def _fill(reg):
    reg.counter("population.escalations").inc()
    reg.counter("population.escalations").inc(4)
    for v in (3.0, 9.0, 1.0):
        reg.gauge("async.heap_depth").set(v)
    reg.gauge("population.nbytes").set(4800.0)
    for v in np.random.default_rng(3).uniform(0, 2, 5000):
        reg.observation("train.pad_waste").add(float(v))
    reg.observation("async.upload_age")      # created, never added to
    return reg


def test_phase_summary_and_trace_event_match_the_reference(ref):
    recs = _span_dicts()
    assert trace.phase_summary(recs) == ref.trace.phase_summary(recs)
    assert trace.to_trace_event(recs) == ref.trace.to_trace_event(recs)
    assert trace.phase_summary([]) == ref.trace.phase_summary([]) == {}


def test_metric_registry_snapshot_matches_the_reference(ref):
    got = _fill(MetricRegistry())
    want = _fill(ref.metrics.MetricRegistry())
    assert got.snapshot() == want.snapshot()
    assert (got.observations["train.pad_waste"].recent
            == want.observations["train.pad_waste"].recent)
    got.reset()
    assert got.snapshot() == {"counters": {}, "gauges": {},
                              "observations": {}}


def _write_trace(path, recs, metrics):
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "meta", "commit": "abc"}) + "\n")
        for r in recs:
            f.write(json.dumps(r) + "\n")
        f.write(json.dumps({"kind": "metrics", **metrics}) + "\n")


def test_report_matches_the_reference_at_h100_constants(h100_ref, tmp_path):
    path = str(tmp_path / "t.jsonl")
    recs = _span_dicts()
    _write_trace(path, recs, _fill(MetricRegistry()).snapshot())
    got = obs_report.summarize(path, top=5)
    want = h100_ref.report.summarize(path, top=5)
    assert got == want
    assert len(got["compile_offenders"]) == sum(
        (r.get("attrs") or {}).get("compiled", False) for r in recs) > 0
    assert set(got["roofline"]) == {"schedule", "train"}
    texts = []
    for rep_mod in (obs_report, h100_ref.report):
        out = io.StringIO()
        rep_mod.render(got, out=out)
        texts.append(out.getvalue().splitlines())
    # the header and comment lines name each package's environment and roof
    assert texts[0][0].startswith("# trace commit=abc ")
    assert "torch=" in texts[0][0] and "jax=" in texts[1][0]
    assert ([x for x in texts[0] if not x.startswith("#")]
            == [x for x in texts[1] if not x.startswith("#")])
    assert any(x.startswith("roofline,train,") for x in texts[0])


@pytest.mark.parametrize("flops,nbytes,measured", [
    (1e9, 1e9, 1.0), (1e15, 1e9, 0.0), (2.9e14, 1e12, 3.0),
    (0.0, 8.0, 1e-6)])
def test_intensity_context_matches_the_reference_formula(h100_ref, flops,
                                                         nbytes, measured):
    assert (roofline.intensity_context(flops, nbytes, measured_s=measured)
            == h100_ref.roofline.intensity_context(flops, nbytes,
                                                   measured_s=measured))


def test_roofline_terms_and_model_flops_match_the_reference(h100_ref):
    coll = {"all-reduce": 1 << 20, "all-gather": 3 << 18}
    got = roofline.roofline_terms(1e12, 1e10, coll)
    assert got == h100_ref.roofline.roofline_terms(1e12, 1e10, coll)
    assert roofline.dominant(got) == h100_ref.roofline.dominant(got)
    for arch in ("starcoder2-15b", "qwen2-moe-a2.7b", "mamba2-370m"):
        for train in (True, False):
            assert (roofline.model_flops(registry.get(arch), 4096, train)
                    == h100_ref.roofline.model_flops(
                        h100_ref.registry.get(arch), 4096, train))


def test_h100_constants():
    """The H100 SXM5 80GB data-sheet values, and the ridge they give."""
    assert (mesh.PEAK_FLOPS_BF16, mesh.PEAK_FLOPS_F32, mesh.HBM_BW,
            mesh.ICI_BW) == (989e12, 67e12, 3.35e12, 450e9)
    lo = roofline.intensity_context(1e9, 1e9, measured_s=1.0)
    assert lo["bound"] == "memory" and lo["intensity"] == 1.0
    assert lo["ridge"] == 989e12 / 3.35e12
    assert 0 < lo["attained_frac"] <= 1.0
    hi = roofline.intensity_context(1e15, 1e9)
    assert hi["bound"] == "compute" and "attained_frac" not in hi
    with pytest.raises(ValueError):
        roofline.intensity_context(1.0, 0.0)


# ---------------------------------------------------------------------- #
# 2. the contract cases of tests/test_obs.py
# ---------------------------------------------------------------------- #
def test_disabled_path_null_span_and_empty_ring():
    trace.configure(enabled=False)
    assert trace.span("a") is NULL_SPAN and trace.span("b") is NULL_SPAN
    with trace.span("x") as sp:
        assert sp.set(anything=1) is NULL_SPAN
    trace.counter_inc("c")
    trace.gauge_set("g", 1.0)
    trace.observe("o", 1.0)
    trace.set_sim_clock(lambda: 0.0)
    tr = trace.tracer()
    assert tr.spans == [] and tr.sim_clock is None
    assert tr.metrics.snapshot() == {"counters": {}, "gauges": {},
                                     "observations": {}}


def test_disabled_path_allocation_bound():
    trace.configure(enabled=False)
    tracemalloc.start()
    try:
        base, _ = tracemalloc.get_traced_memory()
        for _ in range(10_000):
            with trace.span("hot"):
                pass
        cur, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # the shared NULL_SPAN allocates nothing a call; slack for the
    # interpreter, nothing a iteration
    assert cur - base < 16_384, (base, cur)


def test_traced_decorator_disabled_is_passthrough():
    trace.configure(enabled=False)
    calls = []

    @trace.traced("work")
    def fn(x):
        calls.append(x)
        return x + 1

    assert fn(1) == 2 and calls == [1]
    assert trace.tracer().spans == []
    trace.configure(enabled=True)
    assert fn(2) == 3
    assert [s.name for s in trace.tracer().spans] == ["work"]


def test_span_nesting_well_formed():
    _, spans, _ = _traced(lambda: _port_run(scenario="flip_6to2", **KW))
    by_sid = {s.sid: s for s in spans}
    names = {s.name for s in spans}
    for phase in ("experiment", "round", "schedule", "schedule.pack",
                  "schedule.finalize", "train", "train.bucket", "eval",
                  "attack.apply", "defense.aggregate", "finalize",
                  "eval.global"):
        assert phase in names, (phase, sorted(names))
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["experiment"] and roots[0].depth == 0
    for s in spans:
        assert s.t1 >= s.t0
        if s.parent != -1:
            p = by_sid[s.parent]
            assert p.depth == s.depth - 1
            assert p.t0 <= s.t0 and s.t1 <= p.t1, (p.name, s.name)
    assert trace.tracer()._stack == []


def test_async_dual_clock():
    cfg = dict(CFG, mode="async", async_buffer=4)
    _, spans, snap = _traced(lambda: _port_run(cfg, scenario="flip_6to2",
                                               **KW))
    stamped = [s for s in spans if s.sim_t0 is not None]
    assert {s.name for s in spans} - {s.name for s in stamped} == {
        "experiment"}
    for s in stamped:
        assert s.sim_t1 >= s.sim_t0 >= 0.0 and s.t1 >= s.t0
    sims = [s.sim_t1 for s in stamped if s.name == "async.aggregate"]
    assert sims == sorted(sims) and sims[-1] > 0.0
    assert trace.tracer().sim_clock is None
    assert snap["gauges"]["async.heap_depth"]["max"] >= 1
    assert snap["observations"]["async.upload_age"]["count"] == 8


def test_jsonl_and_trace_event_round_trip(tmp_path):
    trace.configure(enabled=True)
    _port_run(scenario="flip_6to2", **KW)
    spans = list(trace.tracer().spans)
    snap = trace.tracer().metrics.snapshot()
    path = str(tmp_path / "trace.jsonl")
    assert trace.flush_jsonl(path) == path
    meta, recs, metrics = trace.load_jsonl(path)
    assert meta["kind"] == "meta" and "commit" in meta
    assert meta["torch"] == torch.__version__ and "jax" not in meta
    assert [r["name"] for r in recs] == [s.name for s in spans]
    for r, s in zip(recs, spans):
        assert (r["sid"], r["parent"], r["depth"], r["t0"], r["t1"]) == (
            s.sid, s.parent, s.depth, s.t0, s.t1)
    assert {k: metrics[k] for k in snap} == snap
    assert trace.phase_summary(recs) == trace.phase_summary(spans)
    ev = trace.to_trace_event(recs)
    assert ev["displayTimeUnit"] == "ms"
    assert len(ev["traceEvents"]) == len(recs)
    for e in ev["traceEvents"]:
        assert e["ph"] == "X" and e["ts"] >= 0.0 and e["dur"] >= 0.0
    json.loads(json.dumps(ev))
    trace.configure(enabled=False)
    with pytest.raises(ValueError, match="no trace path"):
        trace.flush_jsonl()


def test_kernel_build_probe_marks_the_span_that_loaded(monkeypatch,
                                                       tmp_path):
    """``compiled`` is True on exactly the span during which a kernel
    library was built or loaded (here: a stand-in for ``build.load`` that
    the first training call goes through), and the report lists it."""
    fake = functools.cache(lambda name: object())
    monkeypatch.setattr(build, "load", fake)
    assert trace.kernels_loaded() == 0
    real = server_mod.cohort.cohort_train

    def loading(*a, **k):
        build.load("flash_attention")
        return real(*a, **k)

    monkeypatch.setattr(server_mod.cohort, "cohort_train", loading)
    _, spans, snap = _traced(lambda: _port_run(scenario="flip_6to2", **KW))
    marks = [(s.name, s.attrs.get("compiled")) for s in spans
             if s.attrs and "compiled" in s.attrs]
    assert marks[0] == ("train.bucket", True)
    assert marks.count(("train.bucket", True)) == 1
    assert {n for n, c in marks} == {"train.bucket", "eval",
                                     "defense.aggregate"}
    assert snap["gauges"]["compile.kernels_loaded"]["value"] == 1.0
    trace.configure(enabled=True)
    trace.tracer().spans.extend(spans)
    path = trace.flush_jsonl(str(tmp_path / "t.jsonl"))
    rep = obs_report.summarize(path)
    assert [o["name"] for o in rep["compile_offenders"]] == ["train.bucket"]
    assert "compiled" not in rep["compile_offenders"][0]["attrs"]


def test_report_summarize_and_render(tmp_path):
    cfg = dict(CFG, rounds=3)
    trace.configure(enabled=True)
    _port_run(cfg, scenario="flip_6to2", **dict(KW, rounds=3))
    path = trace.flush_jsonl(str(tmp_path / "trace.jsonl"))
    rep = obs_report.summarize(path)
    for phase in ("round", "schedule", "train", "eval"):
        assert rep["phases"][phase]["count"] >= 3, sorted(rep["phases"])
    for phase in ("schedule", "train"):
        r = rep["roofline"][phase]
        assert r["intensity"] > 0 and r["bound"] in ("compute", "memory")
        assert r["ridge"] == mesh.PEAK_FLOPS_BF16 / mesh.HBM_BW
        assert 0 < r["time_floor_s"] < 10.0
    assert rep["compile_offenders"] == []     # the CPU builds no kernel
    out = io.StringIO()
    obs_report.render(rep, out=out)
    text = out.getvalue()
    assert text.startswith("# trace commit=")
    assert "phase,count,total_s,p50_s,p95_s" in text
    assert "H100" in text
    assert "roofline,train," in text and "roofline,schedule," in text
    assert obs_report.main([path, "--json"]) == 0


def test_report_cli_module_runs(tmp_path):
    trace.configure(enabled=True)
    _port_run(scenario="none", **KW)
    path = trace.flush_jsonl(str(tmp_path / "trace.jsonl"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", path],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "phase,count,total_s,p50_s,p95_s" in r.stdout
    assert "roofline,train," in r.stdout


def test_environment_recipe_flushes_at_exit(tmp_path):
    """``REPRO_TRACE=1 REPRO_TRACE_FILE=PATH`` traces a run of a fresh
    interpreter and writes the file when it exits."""
    path = tmp_path / "env.jsonl"
    code = ("from repro_torch.federated.simulation import run_experiment\n"
            "from repro_torch.configs.base import FeelConfig\n"
            "run_experiment(cfg=FeelConfig(n_ues=6, n_malicious=1), "
            "n_train=900, n_test=200, rounds=1, device='cpu')\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=300, env={"PYTHONPATH": str(ROOT / "src"),
                                     "PATH": "/usr/bin:/bin",
                                     "REPRO_TRACE": "1",
                                     "REPRO_TRACE_FILE": str(path)})
    meta, spans, metrics = trace.load_jsonl(str(path))
    assert [s["name"] for s in spans if s["parent"] == -1] == ["experiment"]
    assert metrics["gauges"]["launches.weighted_aggregate"]["value"] == 0.0


def test_configure_bounds_the_ring_and_resets():
    tr = trace.configure(enabled=True, ring_size=8)
    for i in range(20):
        with trace.span(f"s{i}"):
            pass
    assert len(tr.spans) <= 8
    assert tr.spans[-1].name == "s19"
    trace.configure(enabled=False, ring_size=trace._RING)
    assert tr.spans == [] and tr.enabled is False


def test_experiment_metrics_captured():
    _, _, snap = _traced(lambda: _port_run(scenario="flip_6to2", **KW))
    assert snap["observations"]["train.pad_waste"]["count"] == 2
    occ = snap["observations"]["train.bucket_occupancy"]
    assert occ["count"] >= 2 and 0.0 < occ["max"] <= 1.0
    gauges = snap["gauges"]
    assert set(gauges) == {"compile.kernels_loaded"} | {
        f"launches.{k}" for k in build.KERNELS}
    assert all(g["value"] == 0.0 for g in gauges.values())   # the CPU


# ---------------------------------------------------------------------- #
# 3. zero semantic footprint: tracing on == tracing off, bit for bit
# ---------------------------------------------------------------------- #
def _record_servers(monkeypatch):
    made = []

    class Recording(simulation.FeelServer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(simulation, "FeelServer", Recording)
    return made


def _assert_bitwise_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_bitwise_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)) and a and all(
            isinstance(x, (int, float)) and not isinstance(x, bool)
            for x in a):
        assert np.array_equal(np.asarray(a, float), np.asarray(b, float),
                              equal_nan=True), (a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_bitwise_equal(x, y)
    elif isinstance(a, float):
        assert a == b or (np.isnan(a) and np.isnan(b)), (a, b)
    else:
        assert a == b, (a, b)


def _assert_servers_equal(off, on):
    assert len(off) == len(on) > 0
    for s0, s1 in zip(off, on):
        assert s0.rng.bit_generator.state == s1.rng.bit_generator.state
        assert s0.params.keys() == s1.params.keys()
        for k in s0.params:
            assert torch.equal(s0.params[k], s1.params[k]), k
        assert len(s0.logs) == len(s1.logs) > 0
        for l0, l1 in zip(s0.logs, s1.logs):
            _assert_bitwise_equal(dataclasses.asdict(l0) | {
                "selected": l0.selected.tolist(),
                "values": l0.values.tolist(),
                "reputations": l0.reputations.tolist()},
                dataclasses.asdict(l1) | {
                    "selected": l1.selected.tolist(),
                    "values": l1.values.tolist(),
                    "reputations": l1.reputations.tolist()})


def _mnist(engine, control, mode):
    cfg = dict(CFG, mode=mode, async_buffer=4 if mode == "async" else None)
    return lambda: simulation.run_experiment(
        cfg=FeelConfig(**cfg), engine=engine, control=control,
        scenario="flip_6to2", device="cpu", **KW)


FOOTPRINT = {
    **{f"{e}-{c}-{m}": _mnist(e, c, m) for e in ("vectorized", "loop")
       for c in ("batched", "host") for m in ("sync", "async")},
    "lm_tiny": lambda: simulation.run_experiment(
        cfg=FeelConfig(n_ues=8, n_malicious=2), task="lm_tiny",
        scenario="token_flip_1to5", device="cpu", **LM_KW),
    "population": lambda: simulation.run_experiment(
        cfg=FeelConfig(**CFG), population=120, scenario="sign_flip",
        defense="trimmed_mean+validation", device="cpu",
        **dict(KW, n_train=2500)),
    "sweep": lambda: dataclasses.asdict(simulation.run_sweep(
        ["dqs", "random"], seeds=[0, 1], cfg=FeelConfig(**CFG),
        scenarios=["sign_flip"], defenses=["none", "median"],
        n_train=1500, n_test=300, rounds=2, device="cpu")),
}


@pytest.mark.parametrize("case", list(FOOTPRINT))
def test_tracing_on_is_bit_equal_to_tracing_off(monkeypatch, case):
    made = _record_servers(monkeypatch)
    off = FOOTPRINT[case]()
    servers_off = list(made)
    made.clear()
    on, spans, _ = _traced(FOOTPRINT[case])
    assert spans, "the traced run recorded no span"
    _assert_bitwise_equal(off, on)
    _assert_servers_equal(servers_off, made)
    if "async" in case:
        assert off["sim_time"] == on["sim_time"] and on["sim_time"][-1] > 0


# ---------------------------------------------------------------------- #
# 4. span-tree parity with the reference's traced run_experiment
# ---------------------------------------------------------------------- #
PARITY = {
    "sync vectorized batched": (CFG, dict(scenario="flip_6to2")),
    "loop host": (CFG, dict(scenario="flip_6to2", engine="loop",
                            control="host")),
    "async": (dict(CFG, mode="async", async_buffer=4),
              dict(scenario="stale_rider_2")),
    "defended": (CFG, dict(scenario="sign_flip",
                           defense="trimmed_mean+validation")),
    "population": (CFG, dict(population=120, n_train=2500)),
}


def _tree(spans):
    """(span record without the wall clock and ``compiled``, its sim
    stamps) of every span, in completion order."""
    out = []
    for s in spans:
        d = {k: v for k, v in s.to_dict().items() if k not in WALL + SIM}
        d["attrs"] = {k: v for k, v in d.get("attrs", {}).items()
                      if k != "compiled"}
        out.append((d, tuple(getattr(s, k) for k in SIM)))
    return out


def _comparable_metrics(snap):
    return dict(snap, gauges={k: v for k, v in snap["gauges"].items()
                              if not k.startswith(("compile.",
                                                   "launches."))})


@pytest.mark.parametrize("case", list(PARITY))
def test_span_tree_matches_the_reference(ref, case):
    cfg, kw = PARITY[case]
    kw = dict(KW, **kw)
    _, want, want_m = _traced(lambda: ref.sim.run_experiment(
        cfg=ref.cfg.FeelConfig(**cfg), **kw), ref.trace)
    _, got, got_m = _traced(lambda: _port_run(cfg, **kw))
    assert [s.name for s in got] == [s.name for s in want]
    assert _tree(got) == _tree(want)
    assert _comparable_metrics(got_m) == _comparable_metrics(want_m)
    assert any(s.attrs for s in got)


def test_sweep_span_tree_matches_the_reference(ref):
    kw = dict(seeds=[0], scenarios=["sign_flip"],
              defenses=["none", "trimmed_mean+validation"], n_train=1500,
              n_test=300, rounds=2)
    _, want, want_m = _traced(lambda: ref.sim.run_sweep(
        ["dqs", "random"], cfg=ref.cfg.FeelConfig(**CFG), **kw), ref.trace)
    _, got, got_m = _traced(lambda: simulation.run_sweep(
        ["dqs", "random"], cfg=FeelConfig(**CFG),
        tasks=[ref_init_task("mnist_mlp")], device="cpu", **kw))
    assert _tree(got) == _tree(want)
    assert _comparable_metrics(got_m) == _comparable_metrics(want_m)
    assert {s.name for s in got} >= {"schedule", "schedule.pack", "train",
                                     "attack.apply", "eval",
                                     "eval.validation", "defense.aggregate",
                                     "eval.global", "finalize",
                                     "defense.detect", "schedule.finalize"}


# ---------------------------------------------------------------------- #
# 5. tracing adds no host read of a tensor
# ---------------------------------------------------------------------- #
HOST_READS = ("item", "tolist", "cpu", "numpy", "__float__", "__int__",
              "__bool__")


def _count_host_reads(monkeypatch, fn):
    counts = collections.Counter()

    def counting(name, real):
        def wrapper(*a, **k):
            counts[name] += 1
            return real(*a, **k)
        return wrapper

    with monkeypatch.context() as mp:
        for name in HOST_READS:
            mp.setattr(torch.Tensor, name,
                       counting(name, getattr(torch.Tensor, name)))
        mp.setattr(torch.cuda, "synchronize",
                   counting("synchronize", torch.cuda.synchronize))
        fn()
    return counts


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_tracing_adds_no_host_read(monkeypatch, mode):
    cfg = FeelConfig(**CFG, mode=mode,
                     async_buffer=4 if mode == "async" else None)

    def run():
        simulation.run_experiment(cfg=cfg, scenario="sign_flip",
                                  defense="trimmed_mean+validation",
                                  device="cpu", **KW)

    off = _count_host_reads(monkeypatch, run)
    trace.configure(enabled=True)
    on = _count_host_reads(monkeypatch, run)
    assert trace.tracer().spans
    assert off == on and sum(off.values()) > 0, (off, on)
