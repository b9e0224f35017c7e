"""Async FEEL simulation CLI: accuracy against the SIMULATED clock.

Configures an event-driven run (federated/async_engine.py: trigger,
staleness discount, latency scale, channel correlation), runs it through
``run_experiment`` and reports accuracy against the simulated wall clock,
the axis the synchronous engine cannot produce.

    python -m repro_torch.launch.serve --rounds 8 --buffer 4 \\
        --scenario stale_rider_2 --defense validation
    python -m repro_torch.launch.serve --sync        # lockstep oracle run
    python -m repro_torch.launch.serve --json        # machine-readable
    python -m repro_torch.launch.serve --device cpu  # without a GPU
    python -m repro_torch.launch.serve --trace run.jsonl
    python -m repro_torch.obs.report run.jsonl       # its phases

The clock is simulated (Eq. 6 train time + Eq. 7 upload time on seeded
draws): the CLI never reads the wall clock, so a run is a function of
its flags and seed. The data plane runs on ``--device`` (default ``cuda``,
which raises without CUDA). ``--trace PATH`` turns the span tracer on
(obs/trace.py) and writes the run's JSONL trace to PATH: every span inside
the event loop carries the simulated clock beside the wall clock.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, Optional

from repro_torch.configs.base import FeelConfig
from repro_torch.device import DeviceLike
from repro_torch.federated.simulation import run_experiment
from repro_torch.obs import trace


def simulate(policy: str = "dqs", task: Optional[str] = None,
             scenario: str = "none", defense: str = "none",
             seed: int = 0, rounds: Optional[int] = None,
             n_train: Optional[int] = None, n_test: Optional[int] = None,
             mode: str = "async", buffer: Optional[int] = None,
             deadline: Optional[float] = None, staleness: float = 0.5,
             latency_scale: float = 1.0, channel_corr: float = 0.0,
             cfg: Optional[FeelConfig] = None, device: DeviceLike = None,
             **kw) -> Dict:
    """One CLI run: an async (or ``mode="sync"`` oracle) experiment with
    the trigger, staleness and latency knobs mapped onto ``FeelConfig``.
    Returns ``run_experiment``'s curves (an async run adds ``sim_time``,
    ``trigger``, ``n_uploads`` and ``mean_age``)."""
    cfg = dataclasses.replace(
        cfg or FeelConfig(), mode=mode, async_buffer=buffer,
        async_deadline=deadline, async_staleness=staleness,
        async_latency_scale=latency_scale, channel_corr=channel_corr,
        **({"task": task} if task is not None else {}))
    return run_experiment(policy=policy, cfg=cfg, seed=seed, rounds=rounds,
                          n_train=n_train, n_test=n_test, scenario=scenario,
                          defense=defense, device=device, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="event-driven FEEL simulation (accuracy vs simulated "
                    "wall-clock)")
    ap.add_argument("--policy", default="dqs")
    ap.add_argument("--task", default=None,
                    help="task registry name (default: cfg.task)")
    ap.add_argument("--scenario", default="none")
    ap.add_argument("--defense", default="none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rounds", type=int, default=None,
                    help="aggregations to run (default: cfg.rounds)")
    ap.add_argument("--n-train", type=int, default=None)
    ap.add_argument("--n-test", type=int, default=None)
    ap.add_argument("--ues", type=int, default=None,
                    help="override cfg.n_ues (bandwidth budget K)")
    ap.add_argument("--malicious", type=int, default=None,
                    help="override cfg.n_malicious")
    ap.add_argument("--sync", action="store_true",
                    help="run the lockstep oracle engine instead")
    ap.add_argument("--buffer", type=int, default=None,
                    help="aggregate once this many uploads are buffered "
                         "(default: wait for the whole wave)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="also flush the buffer at dispatch + D sim-seconds")
    ap.add_argument("--staleness", type=float, default=0.5,
                    help="staleness discount base decay**age (in (0, 1])")
    ap.add_argument("--latency-scale", type=float, default=1.0,
                    help="scale simulated upload latencies (0 = oracle limit)")
    ap.add_argument("--channel-corr", type=float, default=0.0,
                    help="AR(1) channel correlation rho (0 = memoryless)")
    ap.add_argument("--json", dest="as_json", action="store_true",
                    help="emit the full result dict as JSON on stdout")
    ap.add_argument("--device", default="cuda",
                    help="where the data plane runs (default: cuda, which "
                         "raises without CUDA)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="enable the span tracer and write the JSONL trace "
                         "to PATH; inspect it with python -m "
                         "repro_torch.obs.report PATH")
    args = ap.parse_args(argv)

    if args.trace:
        trace.configure(enabled=True)

    cfg = FeelConfig()
    over = {}
    if args.ues is not None:
        over["n_ues"] = args.ues
    if args.malicious is not None:
        over["n_malicious"] = args.malicious
    if over:
        cfg = dataclasses.replace(cfg, **over)
    res = simulate(policy=args.policy, task=args.task,
                   scenario=args.scenario, defense=args.defense,
                   seed=args.seed, rounds=args.rounds,
                   n_train=args.n_train, n_test=args.n_test,
                   mode="sync" if args.sync else "async",
                   buffer=args.buffer, deadline=args.deadline,
                   staleness=args.staleness,
                   latency_scale=args.latency_scale,
                   channel_corr=args.channel_corr, cfg=cfg,
                   device=args.device)
    if args.trace:
        trace.flush_jsonl(args.trace)
    if args.as_json:
        print(json.dumps(res))
        return 0
    sim_t = res.get("sim_time")
    print(f"# task={res['task']} policy={args.policy} "
          f"scenario={res['scenario']} defense={res['defense']} "
          f"mode={'sync' if args.sync else 'async'}")
    if sim_t is None:
        print("round,acc")
        for t, a in enumerate(res["acc"]):
            print(f"{t},{a:.4f}")
    else:
        print("version,sim_s,acc,trigger,n_uploads,mean_age")
        for t, a in enumerate(res["acc"]):
            print(f"{t},{sim_t[t]:.1f},{a:.4f},{res['trigger'][t]},"
                  f"{res['n_uploads'][t]},{res['mean_age'][t]:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
