"""Shared helpers of the example drivers' tests
(``tests/test_torch_examples_*.py``, one file a driver): the torch twins
(``examples/*_torch.py``) on the CPU beside the reference drivers
(``examples/{quickstart,poisoning_study,robustness_extensions,
federated_llm}.py``), each imported by path after tests/torch_parity.py
(which installs the R1 alias), not through their ``sys.path`` insert.

Each twin's functions run at a tiny setting (3,000/500 samples, 2 rounds,
seed 0; the LM legs at their smallest rounds) beside the reference's same
functions, the port started from the reference's initial params
(``ref_init_task``). The checks (``close``): ``malicious_selected_mean``,
``recovery_rounds`` and ``n_flagged`` exact, and the quickstart's
selection counts; accuracies, losses and ``rep_gap`` within 1e-2 (the
data plane's tolerance); the LM ``dqs_advantage``, a difference of two
such losses, within 2e-2.

Each twin's ``main([... "--device", "cpu"])`` runs once with its settings
constants shrunk (``shrink``), in a temporary working directory: it
writes only its ``results/*_torch.json``, whose keys are the reference's
(``results/{poisoning_study,robustness,federated_llm}.json``'s top level;
each entry's keys those the reference driver writes today: the committed
``poisoning_study.json`` predates ``attack_success`` and
``recovery_rounds``). Without ``--device`` each raises where CUDA is
absent, before it writes anything (``check_defaults_to_the_card``).
"""
from __future__ import annotations

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch
from torch_parity import ref_init_task, reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
KW = dict(n_train=3000, n_test=500, rounds=2)
SEEDS = (0,)
TOL = 1e-2
EXACT = ("malicious_selected_mean", "recovery_rounds", "n_flagged",
         "bit_exact")
RESULTS = {"poisoning_study": "poisoning_study",
           "robustness_extensions": "robustness",
           "federated_llm": "federated_llm"}


def load(name, tag):
    """``examples/<name>.py`` imported by path as module ``<tag>_<name>``."""
    spec = importlib.util.spec_from_file_location(
        f"{tag}_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_driver(name):
    """The reference driver ``name`` and the reference's ``configs.base``
    (as ``.cfg``), the R1 alias installed first."""
    reference("core")                   # the alias, before the drivers
    mod = load(name, "ref")
    mod.cfg = reference("configs.base")
    return mod


def twin_driver(name):
    return load(f"{name}_torch", "twin")


def close(got, want, label):
    """A summary dict of a twin against the reference's."""
    assert got.keys() == want.keys(), label
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            close(g, w, f"{label}.{k}")
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


def shrink(mod, name, monkeypatch):
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


def check_main_writes_its_json(name, tmp_path, monkeypatch, entry=None):
    """Twin ``name``'s ``main(["--fast", "--device", "cpu"])``, shrunk,
    in ``tmp_path``: it writes only ``results/<name>_torch.json``, the
    dict it returns, with the reference's keys (a ``poisoning_study``
    entry's keys are ``entry``'s)."""
    mod = twin_driver(name)
    shrink(mod, name, monkeypatch)
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
        assert all(_keys(v) == _keys(entry) for v in got.values())
    else:
        assert _keys(got) == _keys(want)


def check_defaults_to_the_card(name, tmp_path, monkeypatch):
    """Without ``--device`` twin ``name`` runs on the GPU: where CUDA is
    absent it raises before any work, and writes nothing."""
    mod = twin_driver(name)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main(["--fast"] if name != "quickstart" else [])
    assert not any(tmp_path.iterdir())


LM_LEGS = {"sweep": lambda m, **k: m.dqs_vs_random([0], 2, **k),
           "parity": lambda m, **k: m.loop_parity(1, **k),
           "flash": lambda m, **k: m.flash_leg(1, **k)}


def twin_lm_legs(legs):
    """``examples/federated_llm_torch``'s ``legs`` of ``LM_LEGS`` ("sweep":
    leg 1 at 2 rounds, "parity": leg 2 at 1, "flash": leg 3 at 1) on the
    CPU, the reference's initial params injected through its
    ``run_sweep`` / ``run_experiment``: {leg: its summary}."""
    fl = twin_driver("federated_llm")
    task = ref_init_task("lm_tiny")
    with pytest.MonkeyPatch.context() as mp:
        real_sweep, real_run = fl.run_sweep, fl.run_experiment
        mp.setattr(fl, "run_sweep",
                   lambda *a, **k: real_sweep(*a, **{**k, "tasks": [task]}))
        mp.setattr(fl, "run_experiment",
                   lambda *a, **k: real_run(*a, task=task, **k))
        return {leg: LM_LEGS[leg](fl, device="cpu") for leg in legs}


def reference_lm_legs(legs):
    """The reference driver's same ``legs``: {leg: its summary}."""
    rf = reference_driver("federated_llm")
    return {leg: LM_LEGS[leg](rf) for leg in legs}
