"""The torch twins of the example drivers (``examples/*_torch.py``) on the
CPU, beside the reference drivers (``examples/{quickstart,poisoning_study,
robustness_extensions,federated_llm}.py``), each imported by path after
tests/torch_parity.py (which installs the R1 alias), not through their
``sys.path`` insert.

Each twin's functions run at a tiny setting (3,000/500 samples, 2 rounds,
seed 0; the LM legs at their smallest rounds) beside the reference's same
functions, the port started from the reference's initial params
(``ref_init_task``). The checks: ``malicious_selected_mean``,
``recovery_rounds`` and ``n_flagged`` exact, and the quickstart's selection
counts; accuracies, losses and ``rep_gap`` within 1e-2 (the data plane's
tolerance); the LM ``dqs_advantage``, a difference of two such losses,
within 2e-2.

Each twin's ``main([... "--device", "cpu"])`` runs once with its settings
constants shrunk, in a temporary working directory: it writes only its
``results/*_torch.json``, whose keys are the reference's
(``results/{poisoning_study,robustness,federated_llm}.json``'s top level;
each entry's keys those the reference driver writes today: the committed
``poisoning_study.json`` predates ``attack_success`` and
``recovery_rounds``). Without ``--device`` each raises where CUDA is
absent, before it writes anything.
"""
import importlib.util
import json
import pathlib
import re
import types

import numpy as np
import pytest
import torch
from torch_parity import ref_init_task, reference, single_threaded  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(n_train=3000, n_test=500, rounds=2)
SEEDS = (0,)
TOL = 1e-2
EXACT = ("malicious_selected_mean", "recovery_rounds", "n_flagged",
         "bit_exact")
DRIVERS = ("quickstart", "poisoning_study", "robustness_extensions",
           "federated_llm")
RESULTS = {"poisoning_study": "poisoning_study",
           "robustness_extensions": "robustness",
           "federated_llm": "federated_llm"}


def _load(name, tag):
    spec = importlib.util.spec_from_file_location(
        f"{tag}_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    reference("core")                   # the alias, before the drivers
    ns = types.SimpleNamespace(**{d: _load(d, "ref") for d in DRIVERS})
    ns.cfg = reference("configs.base")
    return ns


def _twins():
    return types.SimpleNamespace(**{d: _load(f"{d}_torch", "twin")
                                    for d in DRIVERS})


@pytest.fixture(scope="module")
def twin():
    return _twins()


def _close(got, want, label):
    """A summary dict of a twin against the reference's."""
    assert got.keys() == want.keys(), label
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _close(g, w, f"{label}.{k}")
        elif k in EXACT:
            assert g == w, (label, k, g, w)
        elif k in ("det_precision", "det_recall"):
            assert [p is None for p in g] == [p is None for p in w], k
            np.testing.assert_allclose(
                [p for p in g if p is not None],
                [p for p in w if p is not None], atol=TOL, rtol=0,
                err_msg=f"{label}.{k}")
        else:
            tol = 2 * TOL if k == "dqs_advantage" else TOL
            np.testing.assert_allclose(g, w, atol=tol, rtol=0,
                                       err_msg=f"{label}.{k}")


# ---------------------------------------------------------------------- #
# quickstart
# ---------------------------------------------------------------------- #
ROUND = re.compile(r"round (\d+): acc=([\d.]+) selected=(\d+) "
                   r"\(malicious among them: (\d+)\)")


def test_quickstart_matches_the_reference(ref, twin, monkeypatch, capsys):
    """The quickstart at 3,000/500 samples and 2 rounds: the attackers,
    each round's selection count and malicious count exact, accuracies
    within 1e-2; ``main`` hands back the rounds' logs."""
    real_gen = ref.quickstart.generate
    monkeypatch.setattr(ref.quickstart, "generate", lambda a, b, seed:
                        real_gen(KW["n_train"], KW["n_test"], seed=seed))
    monkeypatch.setattr(ref.quickstart, "FeelConfig",
                        lambda rounds: ref.cfg.FeelConfig(rounds=2))
    ref.quickstart.main()
    want = capsys.readouterr().out
    qs = twin.quickstart
    monkeypatch.setattr(qs, "N_TRAIN", KW["n_train"])
    monkeypatch.setattr(qs, "N_TEST", KW["n_test"])
    monkeypatch.setattr(qs, "ROUNDS", 2)
    task = ref_init_task()

    class Injected(qs.FeelServer):
        def __init__(self, *a, **k):
            super().__init__(*a, task=task, **k)

    monkeypatch.setattr(qs, "FeelServer", Injected)
    logs = qs.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert got.splitlines()[:2] == want.splitlines()[:2]
    g, w = ROUND.findall(got), ROUND.findall(want)
    assert len(g) == len(w) == len(logs) == 2
    for a, b, log in zip(g, w, logs):
        assert (a[0], a[2], a[3]) == (b[0], b[2], b[3])
        assert abs(float(a[1]) - float(b[1])) <= TOL + 1e-3
        assert int(a[2]) == log.selected.size


# ---------------------------------------------------------------------- #
# poisoning_study
# ---------------------------------------------------------------------- #
def _ps_settings(mod, cfg_cls):
    """(label, policies, scenario, omega, cfg): Fig. 3's constrained DQS,
    Fig. 2's top-value, the benign control, the baselines."""
    return [
        ("fig3_constrained_both", ["dqs"], mod._flip((6, 2)), (0.5, 0.5),
         cfg_cls(model_size_bits=5e6 * 8)),
        ("fig2_hard_div_only", ["top_value"], mod._flip((8, 4)),
         (0.0, 1.0), None),
        ("control_easy", ["dqs"], mod._control((6, 2), "easy_6to2"),
         (0.5, 0.5), None),
        ("baselines", ["random", "best_channel", "max_count"],
         mod._flip((6, 2)), (0.5, 0.5), cfg_cls(model_size_bits=5e6 * 8)),
    ]


@pytest.fixture(scope="module")
def ps_pair(ref, twin):
    """{label: (twin's curves, reference's curves)}."""
    from repro_torch.configs.base import FeelConfig
    task = ref_init_task()
    out = {}
    for (label, pols, scn, om, cfg), (_, _, rscn, _, rcfg) in zip(
            _ps_settings(twin.poisoning_study, FeelConfig),
            _ps_settings(ref.poisoning_study, ref.cfg.FeelConfig)):
        got = twin.poisoning_study.curves(pols, scn, om, cfg, SEEDS,
                                          device="cpu", tasks=[task], **KW)
        want = ref.poisoning_study.curves(pols, rscn, om, rcfg, SEEDS, **KW)
        out[label] = got, want
    return out


@pytest.mark.parametrize("label", ["fig3_constrained_both",
                                   "fig2_hard_div_only", "control_easy",
                                   "baselines"])
def test_poisoning_study_curves_match_the_reference(ps_pair, label):
    got, want = ps_pair[label]
    _close(got, want, label)


def test_poisoning_study_curve_is_its_curves(twin):
    """``curve`` is one policy of ``curves``."""
    ps = twin.poisoning_study
    args = ("dqs", ps._flip((6, 2)), (0.5, 0.5), None, SEEDS)
    assert ps.curve(*args, device="cpu", **KW) == ps.curves(
        [args[0]], *args[1:], device="cpu", **KW)["dqs"]


# ---------------------------------------------------------------------- #
# robustness_extensions
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def rb_pair(ref, twin):
    """The scenario x defense matrix and the curves, twin and reference."""
    from repro_torch.configs.base import FeelConfig
    task = ref_init_task()
    cfg5 = FeelConfig(model_size_bits=5e6 * 8)
    got = twin.robustness_extensions.matrix(SEEDS, cfg5, device="cpu",
                                            tasks=[task], **KW)
    rb = ref.robustness_extensions
    rcfg5 = ref.cfg.FeelConfig(model_size_bits=5e6 * 8)
    res = rb.run_sweep(["dqs", "random"], seeds=SEEDS,
                       scenarios=rb.SCENARIO_MATRIX,
                       defenses=["none", "trimmed_mean+validation"],
                       cfg=rcfg5, **KW)
    want = dict(rb.summarize(res, scn.name, policy, defense)
                for scn in rb.SCENARIO_MATRIX
                for defense in ("none", "trimmed_mean+validation")
                for policy in ("dqs", "random"))
    curves = {}
    for tag, kw, rkw in (
            ("fixed_omega", dict(cfg=cfg5), dict(cfg=rcfg5)),
            ("adaptive_omega", dict(cfg=cfg5, adaptive_omega=True),
             dict(cfg=rcfg5, adaptive_omega=True))):
        curves[tag] = (
            twin.robustness_extensions.curve(
                tag, SEEDS, device="cpu", policy="dqs",
                attack_pair=(8, 4), task=task, **kw, **KW),
            rb.curve(tag, SEEDS, policy="dqs", attack_pair=(8, 4),
                     **rkw, **KW))
    return got, want, curves


def test_robustness_matrix_matches_the_reference(rb_pair):
    """Every cell of the 9 scenarios x 2 defenses x 2 policies."""
    got, want, _ = rb_pair
    assert list(got) == list(want) and len(got) == 36
    for tag in want:
        _close(got[tag], want[tag], tag)


@pytest.mark.parametrize("tag", ["fixed_omega", "adaptive_omega"])
def test_robustness_curves_match_the_reference(rb_pair, tag):
    got, want = rb_pair[2][tag]
    _close(got, want, tag)


# ---------------------------------------------------------------------- #
# federated_llm
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def lm_pair(ref, twin):
    """The three legs, twin (the reference's initial params injected
    through its ``run_sweep`` / ``run_experiment``) and reference."""
    fl = twin.federated_llm
    task = ref_init_task("lm_tiny")
    with pytest.MonkeyPatch.context() as mp:
        real_sweep, real_run = fl.run_sweep, fl.run_experiment
        mp.setattr(fl, "run_sweep",
                   lambda *a, **k: real_sweep(*a, **{**k, "tasks": [task]}))
        mp.setattr(fl, "run_experiment",
                   lambda *a, **k: real_run(*a, task=task, **k))
        got = {"sweep": fl.dqs_vs_random([0], 2, device="cpu"),
               "parity": fl.loop_parity(1, device="cpu"),
               "flash": fl.flash_leg(1, device="cpu")}
    rf = ref.federated_llm
    want = {"sweep": rf.dqs_vs_random([0], 2), "parity": rf.loop_parity(1),
            "flash": rf.flash_leg(1)}
    return got, want


@pytest.mark.parametrize("leg", ["sweep", "parity", "flash"])
def test_federated_llm_legs_match_the_reference(lm_pair, leg):
    got, want = lm_pair
    _close(got[leg], want[leg], leg)


@pytest.mark.parametrize("key", ["loss", "acc", "malicious_selected"])
def test_loop_parity_holds_the_engines_bit_for_bit(twin, key, monkeypatch):
    """The restored reference check: curves one ulp apart fail
    ``loop_parity`` on every device (no looser check for the card)."""
    fl = twin.federated_llm
    base = {"loss": [1.5, 1.25], "acc": [0.25, 0.5],
            "malicious_selected": [1, 0]}

    def fake(engine, **kw):
        out = {k: list(v) for k, v in base.items()}
        if engine == "loop":
            out[key][1] = float(np.nextafter(np.float32(out[key][1]),
                                             np.float32(2.0)))
        return out
    monkeypatch.setattr(fl, "run_experiment", fake)
    with pytest.raises(AssertionError, match=f"engine mismatch on {key}"):
        fl.loop_parity(2, device="cpu")
    monkeypatch.setattr(fl, "run_experiment",
                        lambda engine, **kw: {k: list(v)
                                              for k, v in base.items()})
    assert fl.loop_parity(2, device="cpu")["bit_exact"] is True
    assert not hasattr(fl, "CARD_LOSS_TOL")


# ---------------------------------------------------------------------- #
# the CLIs
# ---------------------------------------------------------------------- #
def _shrink(mod, name, monkeypatch):
    """The twin's settings constants cut to the tests' size."""
    if name == "quickstart":
        for k, v in (("N_TRAIN", KW["n_train"]), ("N_TEST", KW["n_test"]),
                     ("ROUNDS", 2)):
            monkeypatch.setattr(mod, k, v)
    elif name == "poisoning_study":
        monkeypatch.setattr(mod, "FAST_KW", dict(KW))
        monkeypatch.setattr(mod, "FAST_SEEDS", SEEDS)
    elif name == "robustness_extensions":
        monkeypatch.setattr(mod, "FAST_KW", dict(KW))
        monkeypatch.setattr(mod, "SEEDS", SEEDS)
    else:
        monkeypatch.setattr(mod, "FAST", ([0], 1, 1))
        monkeypatch.setattr(mod, "PARITY_ROUNDS", 1)


def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None
            for k, v in d.items()}


@pytest.mark.parametrize("name", list(RESULTS))
def test_main_writes_only_its_json_with_the_reference_keys(
        ps_pair, name, tmp_path, monkeypatch):
    mod = getattr(_twins(), name)
    _shrink(mod, name, monkeypatch)
    monkeypatch.chdir(tmp_path)
    out = mod.main(["--fast", "--device", "cpu"])
    written = sorted(p.relative_to(tmp_path).as_posix()
                     for p in tmp_path.rglob("*") if p.is_file())
    assert written == [f"results/{RESULTS[name]}_torch.json"]
    got = json.loads((tmp_path / written[0]).read_text())
    assert got == json.loads(json.dumps(out))
    want = json.loads((ROOT / "results" / f"{RESULTS[name]}.json")
                      .read_text())
    if name == "poisoning_study":
        assert got.keys() == want.keys()
        entry = _keys(ps_pair["control_easy"][1]["dqs"])
        assert all(_keys(v) == entry for v in got.values())
    else:
        assert _keys(got) == _keys(want)


@pytest.mark.parametrize("name", DRIVERS)
def test_main_defaults_to_the_card(name, tmp_path, monkeypatch):
    """Without ``--device`` a twin runs on the GPU: where CUDA is absent
    it raises before any work, and writes nothing."""
    mod = getattr(_twins(), name)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--fast"] if name != "quickstart" else [])
    assert not any(tmp_path.iterdir())


# ---------------------------------------------------------------------- #
# the init-spread script
# ---------------------------------------------------------------------- #
def test_init_spread_moves_only_the_initial_params(tmp_path, monkeypatch):
    """``examples/federated_llm_init_spread_torch.py``: offset 0 is the
    driver's leg 1 (its end losses), another offset draws other initial
    params and so other losses; ``main`` writes only its JSON, whose
    summary is that of the margins it prints."""
    spread = _load("federated_llm_init_spread_torch", "twin")
    monkeypatch.setattr(spread.fl, "FAST", ([0], 1, 1))
    monkeypatch.chdir(tmp_path)
    leg = spread.fl.dqs_vs_random([0], 1, device="cpu")
    out = spread.main(["--offsets", "0", "1", "--device", "cpu"])
    zero, one = out["offsets"]["0"], out["offsets"]["1"]
    for policy in ("dqs", "random"):
        np.testing.assert_allclose(zero["end_loss"][policy],
                                   leg[policy]["end_loss_per_seed"],
                                   atol=5e-5, rtol=0)
        assert one["end_loss"][policy] != zero["end_loss"][policy]
    assert abs(zero["margin"] - leg["dqs_advantage"]) <= 1e-4
    margins = [zero["margin"], one["margin"]]
    assert out["mean"] == pytest.approx(np.mean(margins))
    assert out["negative"] == sum(m < 0 for m in margins)
    written = [p.relative_to(tmp_path).as_posix()
               for p in tmp_path.rglob("*") if p.is_file()]
    assert written == ["results/federated_llm_init_spread_torch.json"]
    assert json.loads((tmp_path / written[0]).read_text()) == out


def test_init_spread_defaults_to_the_card(tmp_path, monkeypatch):
    spread = _load("federated_llm_init_spread_torch", "twin")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        spread.main([])
    assert not any(tmp_path.iterdir())
