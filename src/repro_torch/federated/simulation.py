"""End-to-end FEEL experiment runner — the paper's §V protocol.

    run_experiment(...) -> the per-round curves and run summary of one run
    run_sweep(...)      -> tidy per-(task, policy, seed, scenario, defense,
                           round) table of many runs

Protocol (paper §V-A): synthetic-MNIST 50k/10k; sort-by-label groups of 50;
1-30 groups per UE; K=50 UEs, 5 random malicious; 2-layer MLP via FedAvg;
15 rounds; results averaged over independent runs. The threat model is a
``core.attacks.AttackScenario`` (or the legacy knobs), the defense a
``core.defenses.DefensePolicy``, the model/data pair a ``FeelTask``.

A copy of ``repro.federated.simulation`` on the port: the same parameters
and results, plus ``device=`` (the data plane's device and the batched
control plane's; None means ``"cuda"``, which raises without CUDA).
``population=N`` schedules each round from N candidates through the top-M
prefilter (core/population.py); ``cfg.mode="async"`` runs the event-driven
engine (federated/async_engine.py), one event loop a run, and adds the
simulated clock's curves (``sim_time``, ``trigger``, ``n_uploads``,
``mean_age``) to the result.

``run_sweep`` runs a whole (tasks x policies x seeds x scenarios x
defenses) grid: it generates each (task, seed) dataset once, builds each
(task, seed, data attack) partition and its device-resident padded layout
once — shared across policies, defenses and the scenarios with the same
poisoned data — and, with ``stack_runs``, runs round t of every run
together: one batched control-plane call for all schedules, one
``cohort_train_multi`` call per (shared client arrays, size bucket) group,
one ``cohort_eval`` per (task, seed), each run's aggregation through
``_aggregate_cohort`` (one ``weighted_aggregate`` launch a run, or the
defense's ``robust_aggregate``), and one batched Eq. 1 update. Every run
reproduces its sequential ``run_experiment`` twin: the same RNG streams,
selections and curves.

Telemetry: ``run_experiment`` runs inside an ``experiment`` span, a stacked
sweep round's phases inside the reference's spans (``schedule``, ``train``
a task, ``eval``, ``eval.validation``, ``eval.global``, ``finalize``), and
both leave the ``launches.<kernel>`` and ``compile.kernels_loaded`` gauges
at the end of the run — the port's counterpart of the reference's jit
cache sizes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FeelConfig
from repro_torch.core import attacks as atk
from repro_torch.core import control as ctl
from repro_torch.core import defenses as dfs
from repro_torch.core import population as pop
from repro_torch.core.poisoning import pick_malicious
from repro_torch.core.scheduler import Schedule
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated import cohort
from repro_torch.federated.async_engine import AsyncFeelEngine
from repro_torch.federated.server import FeelServer, build_cohort_data
from repro_torch.federated.task import FeelTask, as_task
from repro_torch.kernels.bi_gemm import bi_gemm
from repro_torch.kernels.bi_reduce import bi_reduce
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gemm import moe_gemm
from repro_torch.kernels.robust_aggregate import robust_aggregate
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.weighted_aggregate import weighted_aggregate
from repro_torch.obs import trace

# every kernel wrapper; each counts its launches in ``.launches``
_KERNELS = (weighted_aggregate, robust_aggregate, flash_attention,
            decode_attention, moe_gemm, ssd_scan, bi_gemm, bi_reduce)


def _scenarios(scenarios, attack_pairs, no_attack, model_poison_scale,
               lie_boost) -> List[atk.AttackScenario]:
    """The threat-model axis: explicit scenarios, or the legacy knobs
    shimmed into one scenario a pair (they must stay at their defaults when
    scenarios are given; ``ValueError`` otherwise)."""
    if scenarios is None:
        return [atk.legacy_scenario(tuple(p), no_attack, model_poison_scale,
                                    lie_boost) for p in attack_pairs]
    if (no_attack or model_poison_scale is not None or lie_boost
            or tuple(map(tuple, attack_pairs)) != ((6, 2),)):
        raise ValueError(
            "scenario supersedes the legacy attack knobs (incl. "
            "attack_pair — set AttackScenario.watch instead)")
    return [atk.as_scenario(s) for s in scenarios]


def _gauge_kernels() -> None:
    """End-of-run gauges: each kernel's launches in this process so far
    and the kernel libraries loaded (the reference's ``compile.*`` gauges
    read its jit caches; the port's compile step is the kernel build)."""
    for fn in _KERNELS:
        trace.gauge_set(f"launches.{fn.__name__}", float(fn.launches))
    trace.gauge_set("compile.kernels_loaded", float(trace.kernels_loaded()))


def _summary(server: FeelServer, malicious: np.ndarray) -> Dict:
    """A run's per-round curves and summary, from its server."""
    logs = server.logs
    return {
        "task": server.task.name,
        "scenario": server.scenario.name,
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
            [l.attack_success for l in logs], server.cfg.recovery_threshold),
        "final_reputation_malicious": float(
            np.mean(server.reputation.values[malicious])),
        "final_reputation_honest": float(np.mean(np.delete(
            server.reputation.values, malicious))),
        "malicious": malicious.tolist(),
    }


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
                   control: str = "batched",
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
    registry name; None defers to ``cfg.defense``). ``control`` —
    ``"batched"`` (default) or ``"host"`` (see ``FeelServer``).
    ``population`` — the candidate population N (None: N == K, the
    paper's regime); the partition, the wireless draws and the control
    plane span all N candidates.
    """
    cfg = cfg or FeelConfig()
    device = resolve_device(device)     # raises before any work without CUDA
    tsk = as_task(task if task is not None else cfg.task)
    cfg = dataclasses.replace(cfg, task=tsk.name)
    if population is not None:
        cfg = dataclasses.replace(cfg, population=int(population))
    if omega is not None:
        cfg = dataclasses.replace(cfg, omega_rep=omega[0], omega_div=omega[1])
    n_train = tsk.default_n_train if n_train is None else n_train
    n_test = tsk.default_n_test if n_test is None else n_test
    scn, = _scenarios(None if scenario is None else [scenario],
                      [attack_pair], no_attack, model_poison_scale,
                      lie_boost)
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
    with trace.span("experiment") as sp:
        if trace.enabled():
            sp.set(policy=policy, task=tsk.name, mode=cfg.mode,
                   engine=engine, control=control)
        if cfg.mode == "async":
            # one RoundLog an aggregation, plus the simulated clock's curves
            eng = AsyncFeelEngine(server)
            eng.run(rounds)
        else:
            eng = None
            server.run(rounds)
        if trace.enabled():
            _gauge_kernels()
    out = _summary(server, malicious)
    return out if eng is None else {**out, **_async_curves(eng)}


def _async_curves(eng: AsyncFeelEngine) -> Dict:
    return {"sim_time": [a.sim_time for a in eng.agg_logs],
            "trigger": [a.trigger for a in eng.agg_logs],
            "n_uploads": [a.n_uploads for a in eng.agg_logs],
            "mean_age": [float(np.mean(a.ages)) for a in eng.agg_logs]}


# ---------------------------------------------------------------------- #
# Batched multi-run sweeps
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class SweepResult:
    """Tidy results of a (tasks x policies x seeds x scenarios x defenses)
    sweep.

    rows — one record per (task, policy, seed, scenario, defense, round)
        with the per-round metrics (acc, loss, source_acc, attack_success,
        malicious_selected, objective, rep_gap, forced, and the defense
        metrics n_clipped / n_rejected / n_flagged / det_precision /
        det_recall).
    runs — one record per run, shaped like ``run_experiment``'s return
        value plus ``forced`` and the (task, policy, seed, scenario,
        defense, attack_pair) key (``attack_pair`` is the scenario's
        watched pair, None if it has none).
    """
    rows: List[Dict]
    runs: List[Dict]

    def select(self, **key) -> List[Dict]:
        """Run summaries matching e.g. task=..., policy=..., seed=...,
        scenario=..., defense=..."""
        return [r for r in self.runs
                if all(r[k] == v for k, v in key.items())]

    def mean_curve(self, field: str = "acc", **key) -> np.ndarray:
        """Per-round mean of ``field`` over the runs matching ``key`` (the
        paper's average over independent runs).

        NaN-aware: watch metrics (attack_success, source_acc,
        det_precision, det_recall) are NaN where undefined and must not
        poison the mean of the runs that define them. A round where every
        matched run is NaN stays NaN, without numpy's all-NaN warning.
        """
        runs = self.select(**key)
        if not runs:
            raise KeyError(f"no run matches {key}")
        a = np.asarray([r[field] for r in runs], float)
        finite = np.isfinite(a)
        n = finite.sum(axis=0)
        s = np.where(finite, a, 0.0).sum(axis=0)
        return np.where(n > 0, s / np.maximum(n, 1), np.nan)

    def averaged(self, fields: Sequence[str] = ("acc", "source_acc",
                                                "attack_success",
                                                "malicious_selected",
                                                "rep_gap"),
                 **key) -> Dict[str, np.ndarray]:
        """NaN-aware mean curves of several fields at once."""
        return {f: self.mean_curve(f, **key) for f in fields}


class _SweepRun:
    """One (task, policy, seed, scenario, defense) run's server and its
    in-flight round state."""

    def __init__(self, task, policy, seed, scenario, defense, server,
                 malicious, watch_mask, ty_target):
        self.task = task
        self.policy = policy
        self.seed = seed
        self.scenario = scenario
        self.defense = defense
        self.pair = scenario.watch         # the attack_pair key
        self.server = server
        self.malicious = malicious
        self.watch_mask = watch_mask       # (U,) float32 tensor, source units
        self.ty_target = ty_target         # (U,) unit labels relabelled to the
        #                                    attack's target (== ey if none)
        self.plan = None                   # (values, sched, sel, forced)
        self.stacked = None                # merged cohort params (sel order)
        self.acc_local = None
        self.acc_test = None
        self.acc_val = None                # detector validation accuracies
        self.g_acc = float("nan")
        self.g_loss = float("nan")
        self.src_acc = float("nan")
        self.atk_succ = float("nan")

    def summary(self) -> Dict:
        out = _summary(self.server, self.malicious)
        out.update(policy=self.policy, seed=self.seed,
                   attack_pair=self.pair,
                   forced=[l.forced for l in self.server.logs])
        return out


def run_sweep(policies: Sequence[str], seeds: Sequence[int],
              attack_pairs: Sequence[Tuple[int, int]] = ((6, 2),),
              cfg: Optional[FeelConfig] = None, *,
              tasks: Optional[Sequence] = None,
              scenarios: Optional[Sequence] = None,
              defenses: Optional[Sequence] = None,
              n_train: Optional[int] = None,
              n_test: Optional[int] = None,
              omega: Optional[Tuple[float, float]] = None,
              adaptive_omega: bool = False,
              rounds: Optional[int] = None,
              no_attack: bool = False,
              model_poison_scale: Optional[float] = None,
              lie_boost: float = 0.0,
              engine: str = "vectorized",
              control: str = "batched",
              n_buckets: int = 3,
              stack_runs: bool = True,
              population: Optional[int] = None,
              device: DeviceLike = None) -> SweepResult:
    """Run the (tasks x policies x seeds x scenarios x defenses) grid.

    ``tasks`` — ``FeelTask`` specs (None: ``cfg.task``); parameter dicts
    stack only within a task, so the cohort phases batch per task while the
    control plane (which never touches the model) runs once across every
    run. ``scenarios`` — ``AttackScenario`` specs (None: the legacy
    ``attack_pairs`` + ``no_attack`` / ``model_poison_scale`` /
    ``lie_boost`` knobs, one scenario a pair). ``defenses`` —
    ``DefensePolicy`` specs (None: ``cfg.defense``); defenses are
    deterministic, so every (scenario, defense) cell shares the scenario's
    partitions and RNG streams.

    Every run is exactly ``run_experiment(policy, task=tsk, scenario=scn,
    defense=dfn, seed=seed, ...)``: the same datasets, partitions and RNG
    streams (each run restores its partition's post-partition RNG state).
    With ``stack_runs`` and the vectorized engine the rounds of all runs
    execute together (module docstring); ``control="batched"`` (default)
    then schedules them in one ``control.schedule_runs`` call over a
    sweep-wide ``ControlState`` and updates Eq. 1 in one
    ``finalize_runs``, while ``control="host"`` keeps each run's numpy
    oracle. ``stack_runs=False`` (or ``engine="loop"``) runs the runs one
    after the other on the shared caches — the stacked path's oracle.

    ``population`` — the candidate population N of every run (the
    stacked round schedules through the prefilter). Under
    ``cfg.mode="async"`` every run gets its own event loop (a wave is a
    run's own decision, so rounds cannot interleave across runs), on the
    shared data, partition and cohort caches.

    ``n_train``/``n_test`` default per task; ``device`` — where every
    run's data plane and the batched control plane run (None means
    ``"cuda"``, which raises without CUDA).
    """
    cfg = cfg or FeelConfig()
    device = resolve_device(device)
    if population is not None:
        cfg = dataclasses.replace(cfg, population=int(population))
    if omega is not None:
        cfg = dataclasses.replace(cfg, omega_rep=omega[0],
                                  omega_div=omega[1])
    seeds = [int(s) for s in seeds]
    tsks = ([as_task(cfg.task)] if tasks is None
            else [as_task(t) for t in tasks])
    if len({t.name for t in tsks}) != len(tsks):
        raise ValueError("duplicate task names in the tasks axis")
    scns = _scenarios(scenarios, attack_pairs, no_attack,
                      model_poison_scale, lie_boost)
    dfns = ([dfs.as_defense(cfg.defense)] if defenses is None
            else [dfs.as_defense(d) for d in defenses])

    # -- shared caches, keyed per task ----------------------------------- #
    data_cache = {
        (tsk.name, s): tsk.generate_data(
            n_train if n_train is not None else tsk.default_n_train,
            n_test if n_test is not None else tsk.default_n_test, s)
        for tsk in tsks for s in sorted(set(seeds))}
    part_cache: Dict = {}
    for (tn, seed), (train, _) in data_cache.items():
        tsk = next(t for t in tsks if t.name == tn)
        for scn in scns:
            key = (tn, seed, scn.data_key())
            if key in part_cache:
                continue
            rng = np.random.default_rng(seed)
            malicious = pick_malicious(cfg.n_population, cfg.n_malicious,
                                       rng)
            clients = tsk.partition_clients(
                train, cfg.n_population, rng,
                None if scn.benign else malicious, scn.data,
                context=f"task={tn}, scenario={scn.name}")
            # each run restores the post-partition RNG state, so its
            # stream downstream (wireless placement, channel draws)
            # matches its sequential run_experiment twin's
            part_cache[key] = (clients, malicious, rng.bit_generator.state)

    # one pad_to per task => identical bucket levels across its runs
    pad_to = {tsk.name: max(c.size for (tn, _, _), (clients, _, _)
                            in part_cache.items() if tn == tsk.name
                            for c in clients)
              for tsk in tsks}
    cohort_cache: Dict = {}
    if engine == "vectorized":
        for (tn, seed, akey), (clients, _, _) in part_cache.items():
            tsk = next(t for t in tsks if t.name == tn)
            unit_labels = tsk.unit_labels(data_cache[(tn, seed)][1])
            mask_arr = np.stack(
                [np.isin(unit_labels, np.flatnonzero(tsk.histogram(c.data)))
                 for c in clients]).astype(np.float32)
            cohort_cache[(tn, seed, akey)] = build_cohort_data(
                clients, mask_arr, device, batch_size=tsk.batch_size,
                pad_to=pad_to[tn], n_buckets=n_buckets)

    runs: List[_SweepRun] = []
    for tsk in tsks:
        cfg_t = dataclasses.replace(cfg, task=tsk.name)
        for scn in scns:
            for dfn in dfns:
                for seed in seeds:
                    for policy in policies:
                        key = (tsk.name, seed, scn.data_key())
                        clients, malicious, rng_state = part_cache[key]
                        test = data_cache[(tsk.name, seed)][1]
                        rng = np.random.default_rng(seed)
                        rng.bit_generator.state = rng_state
                        server = FeelServer(
                            cfg_t, clients, test, rng, policy=policy,
                            adaptive_omega=adaptive_omega, scenario=scn,
                            engine=engine, defense=dfn, control=control,
                            pad_to=pad_to[tsk.name], n_buckets=n_buckets,
                            task=tsk, cohort_data=cohort_cache.get(key),
                            device=device)
                        unit_labels = tsk.unit_labels(test)
                        if scn.watch:
                            watch = unit_labels == scn.watch[0]
                            target = np.full_like(unit_labels, scn.watch[1])
                        else:
                            watch = np.zeros(unit_labels.size, bool)
                            target = unit_labels
                        runs.append(_SweepRun(
                            tsk, policy, seed, scn, dfn, server, malicious,
                            torch.as_tensor(watch, dtype=torch.float32,
                                            device=device),
                            torch.as_tensor(target, device=device).long()))

    n_rounds = rounds or cfg.rounds
    if cfg.mode == "async":
        for run in runs:
            AsyncFeelEngine(run.server).run(n_rounds)
    elif stack_runs and engine == "vectorized":
        sweep_ctrl = (ctl.ControlState.from_servers(
            [r.server for r in runs]) if control == "batched" else None)
        for t in range(n_rounds):
            _sweep_round_stacked(runs, t, sweep_ctrl)
    else:
        for run in runs:
            run.server.run(n_rounds)
    if trace.enabled():
        _gauge_kernels()

    rows = [
        {"task": run.task.name,
         "policy": run.policy, "seed": run.seed,
         "scenario": run.scenario.name, "defense": run.defense.name,
         "attack_pair": run.pair,
         "round": l.round, "acc": l.global_acc, "loss": l.global_loss,
         "source_acc": l.source_acc,
         "attack_success": l.attack_success,
         "malicious_selected": l.n_malicious_selected,
         "objective": l.objective, "rep_gap": l.rep_gap,
         "forced": l.forced, "n_clipped": l.n_clipped,
         "n_rejected": l.n_rejected, "n_flagged": l.n_flagged,
         "det_precision": l.det_precision, "det_recall": l.det_recall}
        for run in runs for l in run.server.logs]
    return SweepResult(rows=rows, runs=[r.summary() for r in runs])


_PAD = FeelServer._N_BUCKET


def _schedule_runs_stacked(runs: List[_SweepRun],
                           sweep_ctrl: ctl.ControlState, t: int) -> None:
    """Phase A, batched control plane: draw each run's channel (and
    ``random``-policy permutation) from its own host RNG — the oracle's
    streams — then schedule round t of ALL runs in one
    ``control.schedule_runs`` call and hand each run its Schedule."""
    servers = [r.server for r in runs]
    sweep_ctrl.pull(servers)
    N = servers[0].cfg.n_population
    gains = np.empty((len(runs), N))
    rand_rank = np.empty((len(runs), N), int)
    omega = np.empty((len(runs), 2))
    for i, s in enumerate(servers):
        gains[i], rand_rank[i] = s.draw_control_inputs()
        omega[i] = s._omega(t)
    if sweep_ctrl.cfg.population is not None:
        x, alpha, costs, values, forced, _ = pop.prefilter_schedule_runs(
            sweep_ctrl, gains, rand_rank, omega[:, 0], omega[:, 1])
    else:
        x, alpha, costs, values, forced = ctl.schedule_runs(
            sweep_ctrl, gains, rand_rank, omega[:, 0], omega[:, 1])
    for i, run in enumerate(runs):
        sched = Schedule(x=x[i], alpha=alpha[i], cost=costs[i],
                         value=values[i])
        run.plan = (values[i], sched, sched.selected, bool(forced[i]))


def _gather(params, idx: np.ndarray, device):
    """Rows ``idx`` of every leaf of a stacked params dict, by an index
    tensor (never a slice whose bounds depend on the round's values)."""
    i = torch.as_tensor(idx, device=device)
    return {k: v.index_select(0, i) for k, v in params.items()}


def _train_runs_stacked(runs: List[_SweepRun], t: int) -> None:
    """Phase B for ONE task's runs: one ``cohort_train_multi`` call per
    (shared client arrays, size bucket) group, then each run's rows
    gathered back in selection order, attacks applied."""
    first = runs[0].server
    task, lr, batch_size = runs[0].task, first.lr, first.batch_size
    epochs, device = first.cfg.local_epochs, first.device
    if any(r.server.lr != lr or r.server.batch_size != batch_size
           or r.task != task for r in runs):
        raise ValueError("a task's runs must share lr and batch size")

    # (R, ...) stacked run params; each group's per-row params are one
    # gather from it
    params_all = {k: torch.stack([r.server.params[k] for r in runs])
                  for k in first.params}
    groups: Dict[int, Dict] = {}
    for i, run in enumerate(runs):
        sel = run.plan[2]
        waste_slots = 0
        for bkt, pos, rows in run.server._cohort_parts(sel, t, pad=False):
            g = groups.setdefault(id(bkt), {"bkt": bkt, "parts": []})
            g["parts"].append((i, pos, rows))
            # the single-run path's metric (per-part padded slots); the
            # group pads once, so this is a slight upper bound
            waste_slots += cohort.pad_count(pos.size, _PAD) * bkt["level"]
        run.server.pad_waste.append(waste_slots / max(float(
            run.server._ensure_cohort_data().sizes[sel].sum()), 1.0))

    stacks, acc_parts = [], []
    row_map: Dict[int, List] = {i: [] for i in range(len(runs))}
    g_off = 0            # row offset into the concatenated round stack
    for g in groups.values():
        bkt, parts = g["bkt"], g["parts"]
        rows_cat = [rows for _, _, rows in parts]
        ids_cat = [np.full(rows.size, i) for i, _, rows in parts]
        off = 0
        for i, pos, rows in parts:
            row_map[i].append((pos, g_off + off + np.arange(rows.size)))
            off += rows.size
        n_pad = cohort.pad_count(off, _PAD)
        rows_cat.append(np.full(n_pad - off, bkt["null"]))
        ids_cat.append(np.zeros(n_pad - off, int))   # null rows: any params
        data, mask = first._gather_bucket(bkt, np.concatenate(rows_cat))
        stacked_g, acc_g = cohort.cohort_train_multi(
            task, _gather(params_all, np.concatenate(ids_cat), device), data,
            mask, lr, epochs, batch_size)
        stacks.append(stacked_g)
        acc_parts.append(acc_g)
        g_off += n_pad

    big = cohort.merge_stacks(stacks)        # (g_off, ...) round stack
    acc_all = torch.cat(acc_parts).cpu().numpy().astype(float)  # one sync
    for i, run in enumerate(runs):
        order = np.concatenate([pos for pos, _ in row_map[i]])
        gidx = np.concatenate([g for _, g in row_map[i]])
        inv = np.argsort(order, kind="stable")
        run.stacked, run.acc_local = run.server._apply_attacks(
            run.plan[2], _gather(big, gidx[inv], device), acc_all[gidx][inv],
            t)


def _sweep_round_stacked(runs: List[_SweepRun], t: int,
                         sweep_ctrl: Optional[ctl.ControlState]
                         = None) -> None:
    """One round of every run, batched: phase A the schedules (one
    batched control-plane call, or each run's host oracle when
    ``sweep_ctrl`` is None); B per task one ``cohort_train_multi`` per
    (shared client arrays, size bucket) group; C one ``cohort_eval`` per
    (task, seed) for the uploads, C2 one more for the detectors'
    validation split; D each run's aggregation (``_aggregate_cohort``);
    E one ``cohort_eval_rows`` per (task, seed) for the global, watched
    and attack-success metrics; F the detector penalties, one batched
    Eq. 1 update and the logs.

    Every reshuffle of device rows is a gather by an index tensor, never
    a slice whose bounds depend on the round's selections.
    """
    # -- phase A: schedules ---------------------------------------------- #
    if sweep_ctrl is not None:
        with trace.span("schedule") as sp:
            _schedule_runs_stacked(runs, sweep_ctrl, t)
            if trace.enabled():
                est = runs[0].server._schedule_estimates()
                sp.set(t=t, runs=len(runs),
                       est_flops=est["est_flops"] * len(runs),
                       est_bytes=est["est_bytes"] * len(runs))
    else:
        for run in runs:
            run.plan = run.server._schedule_round(t)

    # -- phase B: train, per task ----------------------------------------- #
    for group in _by_task(runs):
        with trace.span("train") as sp:
            _train_runs_stacked(group, t)
            if trace.enabled():
                ests = [r.server._train_estimates(r.plan[2]) for r in group]
                sp.set(task=group[0].task.name, runs=len(group),
                       est_flops=sum(e["est_flops"] for e in ests),
                       est_bytes=sum(e["est_bytes"] for e in ests))

    # -- phase C: evaluate the uploads, one call per (task, seed) -------- #
    with trace.span("eval"):
        for group in _by_task_seed(runs):
            stacks = [run.stacked for run in group]
            masks = [run.server._eval_masks(run.plan[2], run.plan[2].size)
                     for run in group]
            counts = [run.plan[2].size for run in group]
            for run, a in zip(group, _eval_stacked(group[0].server, stacks,
                                                   masks, counts)):
                run.acc_test = a

    # -- phase C2: the detector runs' uploads AND their start-of-round
    # global models on the held-out split, one extra call per (task, seed)
    with trace.span("eval.validation"):
        for group in _by_task_seed(runs):
            det_runs = [r for r in group
                        if r.server.defense.detector is not None]
            if not det_runs:
                continue
            stacks, masks, counts = [], [], []
            for run in det_runs:
                n = run.plan[2].size
                vm = run.server._val_eval_masks(run.plan[2], n)
                stacks += [run.stacked,
                           cohort.broadcast_params(run.server.params, n)]
                masks += [vm, vm]
                counts += [n, n]
            accs = _eval_stacked(det_runs[0].server, stacks, masks, counts)
            for run, v, g in zip(det_runs, accs[::2], accs[1::2]):
                run.acc_val = np.stack([v, g])

    # -- phase D: each run's aggregation (weights span its buckets) ------ #
    for run in runs:
        sel = run.plan[2]
        run.server._aggregate_cohort(sel, cohort.pad_stacked(
            run.stacked, cohort.pad_count(sel.size, _PAD)))

    # -- phase E: global / watched-unit / attack-success accuracy, one
    # call per (task, seed). A watched run contributes three rows (full
    # test accuracy, watched-unit accuracy, the share of watched units
    # predicted as the attack's target), a watch-less run one; the task's
    # loss metric is one extra evaluation a run (none for the MLP).
    with trace.span("eval.global"):
        for group in _by_task_seed(runs):
            ty = group[0].server._ey
            ones = torch.ones_like(ty, dtype=torch.float32)
            counts = [3 if run.scenario.watch else 1 for run in group]
            stacks = [cohort.broadcast_params(run.server.params, c)
                      for run, c in zip(group, counts)]
            masks, ys = [], []
            for run, c in zip(group, counts):
                if c == 3:
                    masks.append(torch.stack([ones, run.watch_mask,
                                              run.watch_mask]))
                    ys.append(torch.stack([ty, ty, run.ty_target]))
                else:
                    masks.append(ones[None])
                    ys.append(ty[None])
            accs = _eval_stacked(group[0].server, stacks, masks, counts,
                                 ys=ys)
            for run, c, a in zip(group, counts, accs):
                run.g_acc = float(a[0])
                run.g_loss = run.server._global_loss()
                watched = c == 3 and bool(run.watch_mask.any())
                run.src_acc = float(a[1]) if watched else float("nan")
                run.atk_succ = float(a[2]) if watched else float("nan")

    # -- phase F: detector penalties, Eq. 1 + staleness, logs ------------ #
    if sweep_ctrl is not None:
        # the state was pulled in phase A and nothing touched it since:
        # one finalize_runs call for every run, pushed back, then each run
        # logs against its refreshed state
        with trace.span("finalize"):
            ctl.finalize_runs(sweep_ctrl, [run.plan[2] for run in runs],
                              [run.acc_local for run in runs],
                              [run.acc_test for run in runs],
                              penalties=[run.server._detect(run.plan[2],
                                                            run.acc_val)
                                         for run in runs])
            sweep_ctrl.push([run.server for run in runs])
            for run in runs:
                run.server._log_round(t, *run.plan, run.g_acc, run.src_acc,
                                      run.atk_succ, run.g_loss)
    else:
        for run in runs:
            run.server._finalize_round(t, *run.plan, run.acc_local,
                                       run.acc_test, run.g_acc,
                                       run.src_acc, run.atk_succ,
                                       run.acc_val, run.g_loss)
    for run in runs:
        run.plan = run.stacked = run.acc_local = run.acc_test = None
        run.acc_val = None


def _by_task(runs: List[_SweepRun]) -> List[List[_SweepRun]]:
    groups: Dict[str, List[_SweepRun]] = {}
    for run in runs:
        groups.setdefault(run.task.name, []).append(run)
    return list(groups.values())


def _by_task_seed(runs: List[_SweepRun]) -> List[List[_SweepRun]]:
    groups: Dict[Tuple[str, int], List[_SweepRun]] = {}
    for run in runs:
        groups.setdefault((run.task.name, run.seed), []).append(run)
    return list(groups.values())


def _eval_stacked(server, stacks, masks, counts, ys=None) -> List[np.ndarray]:
    """One evaluation over the concatenated per-run stacks, split back.

    Every stack comes from a run on ``server``'s (task, seed), whose test
    inputs and targets are used. ``ys`` — per-run (rows, U) unit labels for
    the rows scored against relabelled targets (attack success); None
    scores every row against the shared test targets."""
    n_pad = cohort.pad_count(sum(counts), _PAD)
    stacked = cohort.pad_stacked(cohort.merge_stacks(stacks), n_pad)
    mask = torch.cat(masks)
    mask = torch.cat([mask, mask.new_zeros((n_pad - mask.shape[0],)
                                           + mask.shape[1:])])
    if ys is None:
        acc = cohort.cohort_eval(server.task, stacked, server._ex,
                                 server._ey, mask)
    else:
        y = torch.cat(ys)
        y_rows = torch.cat([y, y.new_zeros((n_pad - y.shape[0],)
                                           + y.shape[1:])])
        acc = cohort.cohort_eval_rows(server.task, stacked, server._ex,
                                      y_rows, mask)
    acc = acc.cpu().numpy().astype(float)
    return list(np.split(acc[:sum(counts)], np.cumsum(counts)[:-1]))


def averaged(policy, attack_pair, n_runs=3, **kw) -> Dict:
    """The paper reports the average of independent runs per setting —
    run as one batched ``run_sweep`` over the seeds."""
    res = run_sweep([policy], seeds=range(n_runs),
                    attack_pairs=[attack_pair], **kw)
    return {"acc": res.mean_curve("acc").tolist(),
            "malicious_selected":
                res.mean_curve("malicious_selected").tolist(),
            "rep_gap": float(np.mean([r["final_reputation_honest"]
                                      - r["final_reputation_malicious"]
                                      for r in res.runs]))}
