"""Beyond-paper robustness extensions on the PyTorch/CUDA port
(``examples/robustness_extensions.py`` on ``repro_torch``): a threat-model
x DEFENSE matrix. Every scenario family from core/attacks.py — model
poisoning (sign-flip / boosted), free-riders (zero and stale updates),
dishonest reporting on top of a label flip, feature noise, and
intermittent / colluding malicious schedules — runs against DQS and the
random baseline, each cell undefended AND under the
``trimmed_mean+validation`` defense (core/defenses.py), as ONE stacked
``run_sweep``. Plus the adaptive-omega and K=100 scale studies.

The headline question: does the validation detector turn the
feature-noise rep gap positive? The summary prints it and the JSON records
per-cell ``rep_gap`` / detection precision/recall.

    python examples/robustness_extensions_torch.py [--fast] [--device cpu]

It runs on ``--device`` (default ``cuda``, which raises without CUDA); on
the card the undefended cells aggregate through the weighted-aggregate
kernel and the defended ones through the robust-aggregate kernel. Writes
results/robustness_torch.json (the reference's results/robustness.json is
never written).
"""
import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs.base import FeelConfig  # noqa: E402
from repro_torch.core import attacks as atk  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.federated.simulation import (run_experiment,  # noqa: E402
                                              run_sweep)
from repro_torch.obs.clock import wall_clock  # noqa: E402

WATCH = (8, 4)        # the hard pair: all scenario metrics watch it
# the reference driver's settings: --fast, and its full run
FAST_KW = dict(n_train=10_000, n_test=2_000, rounds=6)
FULL_KW = dict(n_train=20_000, n_test=4_000, rounds=10)
SEEDS = (0, 1)
DEFENSES = ["none", "trimmed_mean+validation"]
OUT = "results/robustness_torch.json"


def _w(scenario, tag):
    """Rename + point the scenario's metrics at the hard pair."""
    return dataclasses.replace(scenario, name=tag, watch=WATCH)


SCENARIO_MATRIX = [
    _w(atk.model_poison(-1.0), "model_poison_signflip"),
    _w(atk.model_poison(4.0), "model_poison_boost4"),
    _w(atk.free_rider(0), "free_rider"),
    _w(atk.free_rider(2), "stale_rider"),
    _w(atk.lie_boost(0.3, data=atk.LabelFlip((WATCH,))), "lying_flip"),
    _w(atk.feature_noise(0.8), "feature_noise"),
    _w(atk.intermittent(atk.model_poison(-1.0), period=2),
       "intermittent_signflip"),
    _w(atk.colluding(atk.model_poison(-1.0), period=2),
       "colluding_signflip"),
    atk.AttackScenario("control", watch=WATCH),      # benign baseline
]


def summarize(res, scenario, policy, defense):
    runs = res.select(scenario=scenario, policy=policy, defense=defense)
    curves = res.averaged(("acc", "attack_success", "det_precision",
                           "det_recall"),
                          scenario=scenario, policy=policy,
                          defense=defense)    # NaN-aware cross-seed means
    out = {
        "acc": [round(float(a), 4) for a in curves["acc"]],
        "attack_success": [round(float(a), 4)
                           for a in curves["attack_success"]],
        "recovery_rounds": [r["recovery_rounds"] for r in runs],
        "rep_gap": round(float(np.mean(
            [r["final_reputation_honest"] - r["final_reputation_malicious"]
             for r in runs])), 4),
        "malicious_selected_mean": [round(float(m), 2) for m in np.mean(
            [r["malicious_selected"] for r in runs], 0)],
    }
    if defense != "none":
        def rnd(p):
            return round(float(p), 3) if np.isfinite(p) else None
        out["n_flagged"] = [int(n) for n in np.sum(
            [r["n_flagged"] for r in runs], 0)]
        out["det_precision"] = [rnd(p) for p in curves["det_precision"]]
        out["det_recall"] = [rnd(p) for p in curves["det_recall"]]
    tag = f"{scenario}_{policy}" + ("" if defense == "none"
                                    else "_defended")
    print(f"{tag:46s} acc={out['acc'][-1]:.3f} repgap={out['rep_gap']:+.3f} "
          f"malsel_last={out['malicious_selected_mean'][-1]}")
    return tag, out


def curve(tag, seeds, device=None, **kw):
    runs = [run_experiment(seed=s, device=device, **kw) for s in seeds]
    out = {
        "acc": [round(float(a), 4)
                for a in np.mean([r["acc"] for r in runs], 0)],
        "rep_gap": round(float(np.mean(
            [r["final_reputation_honest"] - r["final_reputation_malicious"]
             for r in runs])), 4),
        "malicious_selected_mean": [round(float(m), 2) for m in np.mean(
            [r["malicious_selected"] for r in runs], 0)],
    }
    print(f"{tag:40s} acc={out['acc'][-1]:.3f} repgap={out['rep_gap']:+.3f} "
          f"malsel_last={out['malicious_selected_mean'][-1]}")
    return out


def matrix(seeds, cfg, device=None, **kw):
    """The whole threat-model x defense matrix in ONE stacked sweep (9
    scenarios x 2 defenses x 2 policies x the seeds), scheduled by one
    batched control-plane call per round, trained as stacked cohorts,
    partitions shared across the defense axis; {tag: summary}."""
    res = run_sweep(["dqs", "random"], seeds=seeds,
                    scenarios=SCENARIO_MATRIX, defenses=DEFENSES, cfg=cfg,
                    device=device, **kw)
    results = {}
    for scn in SCENARIO_MATRIX:
        for defense in DEFENSES:
            for policy in ("dqs", "random"):
                tag, out = summarize(res, scn.name, policy, defense)
                results[tag] = out
    return results


def main(argv=None):
    """Run the study; returns the results written to ``OUT``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, which raises "
                         "without CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    kw = dict(FAST_KW if args.fast else FULL_KW, device=device)
    seeds = SEEDS
    cfg5 = FeelConfig(model_size_bits=5e6 * 8)
    t0 = wall_clock()

    # 1) the threat-model x defense matrix
    results = matrix(seeds, cfg5, **kw)

    # does the validation detector turn the feature-noise rep gap positive?
    fn_un = results["feature_noise_dqs"]["rep_gap"]
    fn_def = results["feature_noise_dqs_defended"]["rep_gap"]
    print(f"\nfeature-noise rep gap: undefended {fn_un:+.3f} -> "
          f"defended {fn_def:+.3f} "
          f"({'REVERSED' if fn_un < 0 < fn_def else 'not reversed'})")

    # 2) adaptive omega vs fixed (paper §V-B.2 suggestion)
    results["fixed_omega"] = curve(
        "fixed_omega", seeds, policy="dqs", attack_pair=WATCH, cfg=cfg5,
        **kw)
    results["adaptive_omega"] = curve(
        "adaptive_omega", seeds, policy="dqs", attack_pair=WATCH, cfg=cfg5,
        adaptive_omega=True, **kw)

    # 3) scale: K=100 UEs, 10 malicious
    cfg100 = dataclasses.replace(cfg5, n_ues=100, n_malicious=10)
    results["k100_dqs"] = curve(
        "k100_dqs", seeds, policy="dqs", attack_pair=WATCH, cfg=cfg100,
        **kw)
    results["k100_random"] = curve(
        "k100_random", seeds, policy="random", attack_pair=WATCH,
        cfg=cfg100, **kw)

    os.makedirs("results", exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(results, f, indent=1)
    print(f"\nwrote {OUT} ({wall_clock()-t0:.0f}s)")
    return results


if __name__ == "__main__":
    main()
