"""Full paper-protocol reproduction of Fig. 2 and Fig. 3 on the PyTorch/CUDA
port (``examples/poisoning_study.py`` on ``repro_torch``).

    python examples/poisoning_study_torch.py [--fast] [--device cpu]

Fig. 2 (§V-B.1): selection of the 5 highest-V_k UEs per round under three
omega weightings (diversity-only / reputation-only / both), for the easy
(6->2) and hard (8->4) label-flip pairs — no wireless constraint.

Fig. 3 (§V-B.2): full DQS (greedy knapsack + bandwidth costs) under the
wireless model. Reported in two regimes: the paper's literal 100 KB update
(bandwidth is slack -> near-full participation) and a constrained 5 MB update
where the knapsack binds.

It runs on ``--device`` (default ``cuda``, which raises without CUDA).
Writes results/poisoning_study_torch.json (the reference's
results/poisoning_study.json is never written) and prints round-by-round
curves.
"""
import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs.base import FeelConfig  # noqa: E402
from repro_torch.core import attacks as atk  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.federated.simulation import run_sweep  # noqa: E402
from repro_torch.obs.clock import wall_clock  # noqa: E402

OMEGAS = [("div_only", (0.0, 1.0)), ("rep_only", (1.0, 0.0)),
          ("both", (0.5, 0.5))]
PAIRS = [("easy_6to2", (6, 2)), ("hard_8to4", (8, 4))]
# the reference driver's settings: --fast, and the paper protocol
FAST_KW = dict(n_train=12_000, n_test=2_000, rounds=8)
FAST_SEEDS = (0, 1)
FULL_KW = dict(n_train=50_000, n_test=10_000, rounds=15)
FULL_SEEDS = (0, 1, 2)
OUT = "results/poisoning_study_torch.json"


def curves(policies, scenario, omega, cfg, seeds, device=None, **kw):
    """One batched sweep over (policies x seeds) of one threat scenario;
    per-policy seed-averaged summaries. All seeds (and policies) of a
    setting run as stacked cohorts — one batched train/eval call per size
    bucket per round."""
    res = run_sweep(policies, seeds=seeds, scenarios=[scenario], cfg=cfg,
                    omega=omega, device=device, **kw)
    out = {}
    for policy in policies:
        runs = res.select(policy=policy)
        out[policy] = {
            "acc": [round(float(a), 4)
                    for a in res.mean_curve("acc", policy=policy)],
            "source_acc": [round(float(a), 4) for a in
                           res.mean_curve("source_acc", policy=policy)],
            "attack_success": [round(float(a), 4) for a in
                               res.mean_curve("attack_success",
                                              policy=policy)],
            "malicious_selected_mean":
                [round(float(m), 2) for m in
                 res.mean_curve("malicious_selected", policy=policy)],
            "recovery_rounds": [r["recovery_rounds"] for r in runs],
            "rep_gap": round(float(np.mean(
                [r["final_reputation_honest"]
                 - r["final_reputation_malicious"] for r in runs])), 4)}
    return out


def curve(policy, scenario, omega, cfg, seeds, device=None, **kw):
    return curves([policy], scenario, omega, cfg, seeds, device=device,
                  **kw)[policy]


def _flip(pair):
    return atk.label_flip(*pair)


def _control(pair, tag):
    """Benign control that still watches the would-be pair's metrics."""
    return atk.AttackScenario(f"none_{tag}", watch=pair)


def main(argv=None):
    """Run the study; returns the results written to ``OUT``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="reduced scale (12k samples, 8 rounds, 2 seeds)")
    ap.add_argument("--engine", choices=["vectorized", "loop"],
                    default="vectorized",
                    help="cohort execution engine (the vectorized engine + "
                         "run_sweep batching make this multi-seed study "
                         "feasible; 'loop' is the sequential oracle)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, which raises "
                         "without CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    kw = dict(FAST_KW if args.fast else FULL_KW)
    seeds = FAST_SEEDS if args.fast else FULL_SEEDS
    kw["engine"] = args.engine
    kw["device"] = device

    results = {}
    t0 = wall_clock()
    for pair_tag, pair in PAIRS:
        # no-attack control: quantifies the damage the flip causes
        key = f"control_{pair_tag}_no_attack"
        results[key] = curve("dqs", _control(pair, pair_tag), (0.5, 0.5),
                             None, seeds, **kw)
        print(f"{key}: {results[key]['acc']} src={results[key]['source_acc']}")
        for om_tag, omega in OMEGAS:
            key = f"fig2_{pair_tag}_{om_tag}"
            results[key] = curve("top_value", _flip(pair), omega, None,
                                 seeds, **kw)
            print(f"{key}: {results[key]['acc']}")
        for regime, bits in [("paper_100KB", 100e3 * 8),
                             ("constrained_5MB", 5e6 * 8)]:
            cfg = FeelConfig(model_size_bits=bits)
            for om_tag, omega in OMEGAS:
                key = f"fig3_{pair_tag}_{regime}_{om_tag}"
                results[key] = curve("dqs", _flip(pair), omega, cfg,
                                     seeds, **kw)
                print(f"{key}: {results[key]['acc']}")
        # baselines for context — one batched sweep over all three policies
        base = curves(["random", "best_channel", "max_count"], _flip(pair),
                      (0.5, 0.5), FeelConfig(model_size_bits=5e6 * 8),
                      seeds, **kw)
        for pol, summary in base.items():
            key = f"baseline_{pair_tag}_{pol}"
            results[key] = summary
            print(f"{key}: {summary['acc']}")

    os.makedirs("results", exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(results, f, indent=1)
    print(f"\nwrote {OUT} ({wall_clock()-t0:.0f}s)")
    return results


if __name__ == "__main__":
    main()
