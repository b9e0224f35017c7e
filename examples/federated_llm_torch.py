"""DQS on federated LM fine-tuning (the ``lm_tiny`` task axis) on the
PyTorch/CUDA port (``examples/federated_llm.py`` on ``repro_torch``).

    python examples/federated_llm_torch.py [--fast] [--skip-flash]
        [--device cpu]

The paper's scheduler is model-free: Eqs. 1-3 and Algorithm 2 read only
reputations, histograms and channel states. This example runs the full
DQS stack on the char-LM task (``task="lm_tiny"``, 2-layer transformer,
per-token masked loss) under a *token-space* poisoning attack, and checks
the paper's claim transfers: DQS matches or beats random scheduling on
held-out LM loss.

Three legs:

1. DQS vs random under vocabulary collapse (every token rewritten to 0 on
   malicious clients). The collapse crushes the poisoned clients'
   Gini-Simpson token diversity (Eq. 2) so their data-quality value V_k
   drops, and the LM-sized model upload (82k params) over a 100 kHz cell
   makes the Eq. 9 knapsack *bind*.

2. Loop-engine parity: the per-client ``engine="loop"`` oracle reproduces
   the vectorized cohort engine's loss/acc curves bit-for-bit on the LM
   task, on the CPU and on the card (where the task plane's products and
   sums run on the batch-invariant kernels, ``models/batch_invariant.py``).

3. Flash attention: a small run whose every attention forward goes
   through ``kernels.flash_attention``. On the card that is the
   hand-written kernel (K3), whatever the leg, so this leg has no switch
   to set (the reference sets ``REPRO_USE_PALLAS=1``); it prints K3's
   launch count beside the loss curve. On the CPU the wrapper takes its
   plain version and counts no launch.

It runs on ``--device`` (default ``cuda``, which raises without CUDA).
Writes results/federated_llm_torch.json (the reference's
results/federated_llm.json is never written).
"""
import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import FeelConfig  # noqa: E402
from repro_torch.core import attacks as atk  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.federated.simulation import (run_experiment,  # noqa: E402
                                              run_sweep)
from repro_torch.federated.task import as_task  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.obs.clock import wall_clock  # noqa: E402

# token-space analogue of the paper's label flip: malicious clients'
# streams collapse to a single symbol (watch pair (1, 0) tracks the
# attack's source/target accuracies through the standard metrics)
COLLAPSE = atk.AttackScenario(
    "token_collapse_all",
    data=atk.TokenFlip(tuple((s, 0) for s in range(1, 64))),
    watch=(1, 0))
# the reference driver's settings: (seeds, rounds, flash rounds)
FAST = ([0, 1], 6, 1)
FULL = ([0, 1, 2], 8, 2)
PARITY_ROUNDS = 2
OUT = "results/federated_llm_torch.json"


def _lm_cfg(**kw):
    """Wireless regime where the knapsack binds for an 82k-param upload:
    model_size_bits is the actual lm_tiny parameter count x 32 bits and
    the cell bandwidth is 100 kHz, so honest UEs cost ~2-3 of the K=20
    bandwidth fractions and Algorithm 2 must choose by V_k/c_k."""
    base = dict(n_ues=20, n_malicious=6, deadline_s=60.0,
                model_size_bits=82240 * 32.0, bandwidth_hz=1e5)
    base.update(kw)
    return FeelConfig(**base)


def dqs_vs_random(seeds, rounds, device=None):
    print("== leg 1: DQS vs random under vocabulary collapse "
          f"(seeds={list(seeds)}, rounds={rounds}) ==")
    t0 = wall_clock()
    res = run_sweep(["dqs", "random"], seeds=seeds, cfg=_lm_cfg(),
                    tasks=["lm_tiny"], scenarios=[COLLAPSE],
                    n_train=2000, n_test=400, rounds=rounds, device=device)
    out = {}
    for policy in ("dqs", "random"):
        runs = res.select(policy=policy)
        loss = np.mean([r["loss"] for r in runs], axis=0)
        mal = np.mean([r["malicious_selected"] for r in runs], axis=0)
        out[policy] = {
            "loss": [round(float(x), 4) for x in loss],
            "end_loss_per_seed": [round(float(r["loss"][-1]), 4)
                                  for r in runs],
            "malicious_selected_mean": [round(float(m), 2) for m in mal]}
        print(f"  {policy:7s} held-out loss {out[policy]['loss']}")
        print(f"  {policy:7s} malicious selected/round "
              f"{out[policy]['malicious_selected_mean']}")
    d_end = np.mean(out["random"]["end_loss_per_seed"]) \
        - np.mean(out["dqs"]["end_loss_per_seed"])
    print(f"  DQS end-loss advantage over random: {d_end:+.4f} "
          f"({wall_clock() - t0:.0f}s)")
    if d_end < 0.0:
        raise AssertionError(
            "DQS should match or beat random on held-out LM loss: "
            f"dqs={out['dqs']['end_loss_per_seed']} "
            f"random={out['random']['end_loss_per_seed']}")
    out["dqs_advantage"] = round(float(d_end), 4)
    return out


def loop_parity(rounds, device=None):
    """The per-client loop engine against the vectorized one, bit for bit
    on loss, acc and malicious_selected, as the reference's leg. On the
    CPU torch runs on one thread for it (multi-threaded CPU matmuls split
    their sums by thread count and batch size); on the card the task
    plane's batch-invariant kernels give a client the same sums alone and
    in a stack."""
    print("== leg 2: loop-engine parity on lm_tiny ==")
    kw = dict(policy="dqs", scenario=atk.as_scenario("token_flip_1to5"),
              cfg=FeelConfig(n_ues=8, n_malicious=2, task="lm_tiny"),
              seed=0, n_train=960, n_test=240, rounds=rounds, device=device)
    on_cpu = resolve_device(device).type == "cpu"
    threads = torch.get_num_threads()
    if on_cpu:
        torch.set_num_threads(1)
    try:
        vec = run_experiment(engine="vectorized", **kw)
        loop = run_experiment(engine="loop", **kw)
    finally:
        torch.set_num_threads(threads)
    for key in ("loss", "acc", "malicious_selected"):
        assert np.array_equal(np.asarray(vec[key]), np.asarray(loop[key]),
                              equal_nan=True), f"engine mismatch on {key}"
    print(f"  loop == vectorized on loss/acc/selection "
          f"(loss curve {[round(float(x), 4) for x in vec['loss']]})")
    return {"loss": [round(float(x), 6) for x in vec["loss"]],
            "bit_exact": True}


def flash_leg(rounds, device=None):
    print("== leg 3: flash-attention training forward "
          "(kernels.flash_attention: K3 on the card) ==")
    t0 = wall_clock()
    before = flash_attention.launches
    r = run_experiment(
        policy="dqs", scenario=atk.as_scenario("token_flip_1to5"),
        cfg=FeelConfig(n_ues=6, n_malicious=2, task="lm_tiny"),
        seed=0, n_train=480, n_test=120, rounds=rounds, device=device)
    launches = flash_attention.launches - before
    if not np.all(np.isfinite(r["loss"])):
        raise AssertionError("flash path produced non-finite loss")
    print(f"  flash loss curve {[round(float(x), 4) for x in r['loss']]} "
          f"K3 launches {launches} ({wall_clock() - t0:.0f}s)")
    return {"loss": [round(float(x), 6) for x in r["loss"]]}


def main(argv=None):
    """Run the three legs; returns the results written to ``OUT``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="reduced scale (2 seeds, 6 rounds, 1 flash round)")
    ap.add_argument("--skip-flash", action="store_true",
                    help="skip the flash-attention leg")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, which raises "
                         "without CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    seeds, rounds, flash_rounds = FAST if args.fast else FULL

    tsk = as_task("lm_tiny")
    print(f"task={tsk.name}: vocab={tsk.n_symbols}, seq={tsk.seq}, "
          f"per-token masked loss; scheduler unchanged (model-free)\n")

    results = {"sweep": dqs_vs_random(seeds, rounds, device),
               "parity": loop_parity(PARITY_ROUNDS, device)}
    if not args.skip_flash:
        results["flash"] = flash_leg(flash_rounds, device)

    os.makedirs("results", exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nwrote {OUT}")
    return results


if __name__ == "__main__":
    main()
