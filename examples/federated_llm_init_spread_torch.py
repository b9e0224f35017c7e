"""The spread of ``federated_llm_torch.py --fast``'s DQS margin over the
LM's initial params.

    python examples/federated_llm_init_spread_torch.py [--offsets 0 1 2]
        [--device cpu]

Leg 1 of ``examples/federated_llm_torch.py`` (DQS vs random under
vocabulary collapse) at its ``--fast`` setting (seeds 0 and 1, 6 rounds),
once for each offset. Every run's data, partition, channel and scheduler
draws are the driver's; only its initial params move: they are drawn from
the run's init seed plus the offset, so offset 0 is the driver's own run.
Prints each offset's end-loss margin (random minus DQS, averaged over the
seeds, as the driver's assertion reads it) and, last, one JSON line with
every margin, their mean and spread. It asserts nothing about the margin.

It runs on ``--device`` (default ``cuda``, which raises without CUDA).
Writes results/federated_llm_init_spread_torch.json.
"""
import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import federated_llm_torch as fl  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.federated.simulation import run_sweep  # noqa: E402
from repro_torch.federated.task import LmTask  # noqa: E402
from repro_torch.obs.clock import wall_clock  # noqa: E402
from repro_torch.random import PRNGKey  # noqa: E402

OFFSETS = tuple(range(8))
OUT = "results/federated_llm_init_spread_torch.json"


@dataclasses.dataclass(frozen=True)
class ShiftedInit(LmTask):
    """``lm_tiny`` with its initial params drawn ``offset`` seeds past the
    run's init seed: from ``PRNGKey(seed + offset)``, where the server's
    key is ``PRNGKey(seed)`` (its low word; the seed is below 2^31)."""
    offset: int = 0

    def init_params(self, key: torch.Tensor, device):
        seed = int(key[1]) + self.offset
        return super().init_params(PRNGKey(seed, device), device)


def margin(offset, device=None):
    """(end-loss margin random - DQS averaged over the seeds, the end
    losses by policy) of leg 1 at the ``--fast`` setting."""
    seeds, rounds, _ = fl.FAST
    res = run_sweep(["dqs", "random"], seeds=seeds, cfg=fl._lm_cfg(),
                    tasks=[ShiftedInit(offset=offset)],
                    scenarios=[fl.COLLAPSE], n_train=2000, n_test=400,
                    rounds=rounds, device=device)
    end = {p: [float(r["loss"][-1]) for r in res.select(policy=p)]
           for p in ("dqs", "random")}
    return float(np.mean(end["random"]) - np.mean(end["dqs"])), end


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--offsets", type=int, nargs="+", default=OFFSETS,
                    help="init-seed offsets (0: the driver's own run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, which raises "
                         "without CUDA)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {"device": str(device), "offsets": {}}
    for off in args.offsets:
        t0 = wall_clock()
        d, end = margin(off, device)
        out["offsets"][str(off)] = {"margin": d, "end_loss": end}
        print(f"offset {off}: DQS end-loss advantage over random {d:+.4f} "
              f"(dqs {end['dqs']}, random {end['random']}; "
              f"{wall_clock() - t0:.0f}s)", flush=True)
    ms = [v["margin"] for v in out["offsets"].values()]
    out.update(mean=float(np.mean(ms)), std=float(np.std(ms)),
               min=float(np.min(ms)), max=float(np.max(ms)),
               negative=int(np.sum(np.asarray(ms) < 0)))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
