"""End-to-end FEEL experiment runner — the paper's §V protocol.

    run_experiment(...) -> the per-round curves and run summary of one run

Protocol (paper §V-A): synthetic-MNIST 50k/10k; sort-by-label groups of 50;
1-30 groups per UE; K=50 UEs, 5 random malicious; 2-layer MLP via FedAvg;
15 rounds. The threat model is a ``core.attacks.AttackScenario`` (or the
legacy knobs), the defense a ``core.defenses.DefensePolicy``.

A copy of ``repro.federated.simulation.run_experiment`` on the port: the
same parameters and the same result dict, plus ``device=`` (the data
plane's device; None means ``"cuda"``, which raises without CUDA). The
control plane defaults to ``control="host"``; ``"batched"``, ``mode="async"``
and ``population=`` raise until their planes are ported, and the multi-run
``run_sweep`` is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import FeelConfig
from repro_torch.core import attacks as atk
from repro_torch.core.poisoning import pick_malicious
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated.server import FeelServer
from repro_torch.federated.task import FeelTask, as_task


def run_experiment(policy: str = "dqs",
                   attack_pair: Tuple[int, int] = (6, 2),
                   cfg: Optional[FeelConfig] = None,
                   seed: int = 0,
                   n_train: Optional[int] = None,
                   n_test: Optional[int] = None,
                   omega: Optional[Tuple[float, float]] = None,
                   adaptive_omega: bool = False,
                   rounds: Optional[int] = None,
                   no_attack: bool = False,
                   model_poison_scale: Optional[float] = None,
                   lie_boost: float = 0.0,
                   engine: str = "vectorized",
                   control: str = "host",
                   scenario=None, defense=None,
                   task: Optional[FeelTask] = None,
                   population: Optional[int] = None,
                   device: DeviceLike = None) -> Dict:
    """One FEEL experiment; returns the per-round curves + run summary.

    ``task`` — a ``federated.task.FeelTask`` (``MnistTask``, ``LmTask``)
    or its registry name (``"mnist_mlp"``, ``"lm_tiny"``); None defers to
    ``cfg.task``. ``n_train``/``n_test`` default to the task's protocol
    sizes, the learning rate and batch size to its ``default_lr`` and
    ``batch_size``.

    Threat model — either an explicit ``scenario`` (an
    ``core.attacks.AttackScenario``, a registry name, or a ``(source,
    target)`` pair) or the legacy knobs:

    - ``model_poison_scale`` REPLACES the label-flip data attack —
      malicious UEs keep clean data and poison their *updates* instead;
    - ``no_attack=True`` wins over everything: no data attack, no model
      poisoning, no lie_boost, and malicious flags are not set;
    - ``lie_boost`` composes with whichever attack is active;
    - metrics always watch ``attack_pair``.

    ``scenario`` supersedes the legacy knobs (they must stay at their
    defaults when it is given; ``ValueError`` otherwise).

    ``defense`` — a ``core.defenses.DefensePolicy`` spec (object or
    registry name; None defers to ``cfg.defense``).
    """
    if population is not None:
        raise NotImplementedError(
            "population= (core/population.py) is not ported yet")
    device = resolve_device(device)     # raises before any work without CUDA
    cfg = cfg or FeelConfig()
    if cfg.mode != "sync":
        raise NotImplementedError(
            "mode='async' (federated/async_engine.py) is not ported yet")
    tsk = as_task(task if task is not None else cfg.task)
    cfg = dataclasses.replace(cfg, task=tsk.name)
    if omega is not None:
        cfg = dataclasses.replace(cfg, omega_rep=omega[0], omega_div=omega[1])
    n_train = tsk.default_n_train if n_train is None else n_train
    n_test = tsk.default_n_test if n_test is None else n_test
    if scenario is not None:
        if (no_attack or model_poison_scale is not None or lie_boost
                or tuple(attack_pair) != (6, 2)):
            raise ValueError(
                "scenario supersedes the legacy attack knobs (incl. "
                "attack_pair — set AttackScenario.watch instead)")
        scn = atk.as_scenario(scenario)
    else:
        scn = atk.legacy_scenario(attack_pair, no_attack,
                                  model_poison_scale, lie_boost)
    rng = np.random.default_rng(seed)
    train, test = tsk.generate_data(n_train, n_test, seed)
    malicious = pick_malicious(cfg.n_population, cfg.n_malicious, rng)
    clients = tsk.partition_clients(train, cfg.n_population, rng,
                                    None if scn.benign else malicious,
                                    scn.data,
                                    context=f"task={tsk.name}, "
                                            f"scenario={scn.name}")
    server = FeelServer(cfg, clients, test, rng, policy=policy,
                        adaptive_omega=adaptive_omega, scenario=scn,
                        engine=engine, control=control, defense=defense,
                        task=tsk, device=device)
    logs = server.run(rounds)
    return {
        "task": tsk.name,
        "scenario": scn.name,
        "defense": server.defense.name,
        "acc": [l.global_acc for l in logs],
        "loss": [l.global_loss for l in logs],
        "source_acc": [l.source_acc for l in logs],
        "attack_success": [l.attack_success for l in logs],
        "malicious_selected": [l.n_malicious_selected for l in logs],
        "objective": [l.objective for l in logs],
        "rep_gap": [l.rep_gap for l in logs],
        "n_clipped": [l.n_clipped for l in logs],
        "n_rejected": [l.n_rejected for l in logs],
        "n_flagged": [l.n_flagged for l in logs],
        "det_precision": [l.det_precision for l in logs],
        "det_recall": [l.det_recall for l in logs],
        "recovery_rounds": atk.recovery_rounds(
            [l.attack_success for l in logs], cfg.recovery_threshold),
        "final_reputation_malicious": float(
            np.mean(server.reputation.values[malicious])),
        "final_reputation_honest": float(np.mean(np.delete(
            server.reputation.values, malicious))),
        "malicious": malicious.tolist(),
    }
