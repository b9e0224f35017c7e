"""Quickstart on the PyTorch/CUDA port (``examples/quickstart.py`` on
``repro_torch``): data-quality based scheduling (DQS) for FEEL.

    python examples/quickstart_torch.py
    python examples/quickstart_torch.py --device cpu

Builds the paper's setup at reduced scale — 50 UEs with non-IID synthetic
MNIST, 5 label-flipping attackers — and runs a few FedAvg rounds under DQS,
printing the accuracy curve and which UEs the scheduler trusted. It runs on
``--device`` (default ``cuda``, which raises without CUDA); on the card
each round's FedAvg is one launch of the weighted-aggregate kernel.
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs.base import FeelConfig  # noqa: E402
from repro_torch.core.poisoning import (EASY_PAIR, LabelFlipAttack,  # noqa: E402
                                        pick_malicious)
from repro_torch.data.partition import partition  # noqa: E402
from repro_torch.data.synthetic_mnist import generate  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.federated.server import FeelServer  # noqa: E402

# the reference driver's setting
N_TRAIN, N_TEST, ROUNDS, SEED = 12_000, 2_000, 6, 0


def main(argv=None):
    """Run the quickstart; returns the rounds' ``RoundLog``s."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, which raises "
                         "without CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(SEED)
    cfg = FeelConfig(rounds=ROUNDS)
    print("generating synthetic MNIST (offline stand-in)...")
    train, test = generate(N_TRAIN, N_TEST, seed=SEED)
    malicious = pick_malicious(cfg.n_ues, cfg.n_malicious, rng)
    clients = partition(train, cfg.n_ues, rng, malicious,
                        LabelFlipAttack(*EASY_PAIR))
    print(f"{cfg.n_ues} UEs, malicious: {sorted(malicious.tolist())}, "
          f"attack {EASY_PAIR[0]}->{EASY_PAIR[1]}")

    # the vectorized cohort engine trains every scheduled UE in one
    # batched step (pass engine="loop" for the sequential per-client oracle)
    server = FeelServer(cfg, clients, test, rng, policy="dqs",
                        engine="vectorized", device=device)
    logs = []
    for t in range(cfg.rounds):
        log = server.run_round(t)
        logs.append(log)
        print(f"round {t}: acc={log.global_acc:.3f} "
              f"selected={len(log.selected)} "
              f"(malicious among them: {log.n_malicious_selected})")
    rep = server.reputation.values
    print(f"\nfinal mean reputation  honest:    "
          f"{np.delete(rep, malicious).mean():.3f}")
    print(f"final mean reputation  malicious: {rep[malicious].mean():.3f}")
    return logs


if __name__ == "__main__":
    main()
