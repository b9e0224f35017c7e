"""FEEL server (Alg. 1): per-round schedule -> local train -> evaluate ->
reputation update -> FedAvg aggregate.

The server sees only what the paper allows it to see: dataset *metadata*
(size, symbol histogram for the diversity index, staleness), self-reported
local accuracies, uploaded models evaluated on the public test set, and
channel state. It never touches raw client data.

The control plane (values -> Eq. 9 costs -> Alg. 2 selection -> Eq. 1
reputation) runs on the host in float64 numpy (``control="host"``), drawing
from the host RNG — the stream of record — at exactly the points the JAX
package's server does. The data plane runs on ``device``:

    "vectorized" (default) — the cohort engine (federated/cohort.py): the
        round's scheduled UEs are split into ``n_buckets`` size buckets,
        each padded only to its own quantized max_samples level, each bucket
        trains at once with an explicit client axis, the per-bucket stacks
        are merged back into selection order, and evaluation + aggregation
        run once on the merged stack — one ``fedavg_stacked`` call, hence
        one ``weighted_aggregate`` kernel launch per round.
    "loop" — the sequential per-client loop, kept as the correctness oracle.

Not ported yet: the batched control plane (``control="batched"``), the
defense plane, model/report attacks, the population cut, async mode and
the observability spans.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FeelConfig
from repro_torch.core.attacks import AttackScenario, reputation_gap
from repro_torch.core.diversity import diversity_index
from repro_torch.core.quality import adaptive_weights, data_quality_value
from repro_torch.core.reputation import ReputationTracker
from repro_torch.core.scheduler import (POLICY_NAMES, Schedule,
                                        best_channel_schedule, dqs_schedule,
                                        max_count_schedule, random_schedule,
                                        top_value_schedule)
from repro_torch.core.wireless import WirelessModel
from repro_torch.data.partition import (ClientData, pad_clients,
                                        pad_clients_bucketed)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated import cohort
from repro_torch.federated.aggregation import fedavg, fedavg_stacked
from repro_torch.federated.task import MnistTask, as_task


@dataclasses.dataclass
class RoundLog:
    round: int
    selected: np.ndarray
    global_acc: float
    n_malicious_selected: int
    objective: float
    values: np.ndarray
    reputations: np.ndarray
    # task-defined global loss metric (NaN for the MNIST MLP)
    global_loss: float = float("nan")
    source_acc: float = float("nan")   # accuracy on the attacked class
    # fraction of watched source-class test samples classified as the
    # attack's TARGET class (NaN without a watched pair)
    attack_success: float = float("nan")
    # honest-vs-malicious reputation separation after this round's Eq. 1
    # update (NaN when the run has no malicious UEs)
    rep_gap: float = float("nan")
    # True when no UE met the deadline and the server forced the
    # highest-value UE. Problem (8) had no feasible point, so ``objective``
    # is 0.0 for forced rounds — the forced UE's V_k is not credited.
    forced: bool = False


@dataclasses.dataclass
class CohortData:
    """Device-resident padded client layout for the vectorized engine.

    ``buckets[b]`` holds one size bucket's per-sample tensors (``data``:
    ``x`` float32, ``y`` int64) and validity mask, laid out as [real client
    rows | clean twin rows | one all-zero "null client" row at index
    ``null``] — cohort-size padding gathers the null row for a strict
    training no-op. The twin rows hold the PRE-POISON data of label-flipped
    clients (``ClientData.clean``): a round-scheduled data attack gathers a
    malicious UE's twin row in its off rounds.
    """
    buckets: List[Dict]       # data/mask tensors, level, null
    bucket_of: np.ndarray     # (K,) bucket index per client
    row_of: np.ndarray        # (K,) row within the client's bucket arrays
    clean_row_of: np.ndarray  # (K,) clean-twin row, -1 when none exists
    mask_dev: torch.Tensor    # (K+1, U) per-UE eval unit masks + null row
    sizes: np.ndarray         # (K,) true sample counts


def build_cohort_data(clients: List[ClientData], test_mask_arr: np.ndarray,
                      device, batch_size: int = 50,
                      pad_to: Optional[int] = None,
                      n_buckets: int = 3) -> CohortData:
    """Bucket, pad and place the clients on ``device`` (see CohortData).

    test_mask_arr — (K, U) float {0,1} per-UE evaluation unit masks (the
    server restricts Eq. 1's acc_test to the classes a UE claims to hold).
    """
    bucketed = pad_clients_bucketed(clients, n_buckets=n_buckets,
                                    multiple_of=batch_size, pad_to=pad_to)
    K = len(clients)
    bucket_of = np.full(K, -1)
    row_of = np.full(K, -1)
    clean_row_of = np.full(K, -1)
    zrow = lambda a: np.concatenate([a, np.zeros_like(a[:1])])
    buckets = []
    for b, (ids, pd) in enumerate(bucketed):
        # loop-engine parity contract: the loop's plain sgd epoch DROPS a
        # tail batch (nb = n // batch_size) while the masked engine would
        # train it, so a non-dividing batch_size must fail loudly
        if np.any(pd.sizes % batch_size):
            raise ValueError(
                "vectorized engine requires batch_size to divide every "
                "client dataset size (the loop oracle drops tail batches)")
        bucket_of[ids] = b
        row_of[ids] = np.arange(ids.size)
        arrays = {f: [a] for f, a in pd.arrays.items()}
        mask_parts = [pd.mask]
        # clean twins share the poisoned row's size (label flips preserve
        # sample counts), so they land in the same bucket level
        twin_ids = [int(i) for i in ids if clients[i].clean is not None]
        if twin_ids:
            tw = pad_clients(
                [dataclasses.replace(clients[i], data=clients[i].clean,
                                     clean=None) for i in twin_ids],
                multiple_of=batch_size, pad_to=pd.max_samples)
            clean_row_of[twin_ids] = ids.size + np.arange(len(twin_ids))
            for f in arrays:
                arrays[f].append(tw.arrays[f])
            mask_parts.append(tw.mask)
        data = {f: torch.as_tensor(zrow(np.concatenate(parts)),
                                   device=device)
                for f, parts in arrays.items()}
        data["y"] = data["y"].long()
        buckets.append({
            "data": data,
            "mask": torch.as_tensor(zrow(np.concatenate(mask_parts)),
                                    device=device),
            "level": pd.max_samples, "null": ids.size + len(twin_ids)})
    return CohortData(
        buckets=buckets, bucket_of=bucket_of, row_of=row_of,
        clean_row_of=clean_row_of,
        mask_dev=torch.as_tensor(zrow(test_mask_arr), device=device),
        sizes=np.array([c.size for c in clients], float))


class FeelServer:
    """policy: 'dqs' | 'random' | 'best_channel' | 'max_count' | 'top_value'.
    'top_value' reproduces §V-B.1 (pure data-quality selection, no wireless).

    engine: 'vectorized' | 'loop' (see module docstring).
    control: 'host' — the sequential numpy control plane; 'batched' is
    ported with the batched-control-plane slice and raises here.
    device: where the data plane runs; None means 'cuda', which raises when
    CUDA is absent (pass 'cpu' to run on the CPU).
    scenario: the threat model's activity schedule and watched pair; the
    label flip itself must already be baked into ``clients``.
    ``lr``/``batch_size`` default to the task's protocol values when None.
    n_buckets: number of max_samples size buckets for the vectorized
    engine. ``params`` may be replaced after construction (the parity tests
    inject the JAX package's initial params that way).
    """

    _N_BUCKET = 8   # cohort sizes are padded to a multiple of this with
                    # zero-weight null clients (stable shapes)

    def __init__(self, cfg: FeelConfig, clients: List[ClientData],
                 test, rng: np.random.Generator,
                 policy: str = "dqs", lr: Optional[float] = None,
                 adaptive_omega: bool = False,
                 engine: str = "vectorized",
                 batch_size: Optional[int] = None,
                 pad_to: Optional[int] = None, n_buckets: int = 3,
                 control: str = "host",
                 scenario: Optional[AttackScenario] = None,
                 defense: Optional[str] = None,
                 task: Optional[MnistTask] = None,
                 device: DeviceLike = None):
        if engine not in ("vectorized", "loop"):
            raise ValueError(f"unknown engine {engine!r}")
        if control == "batched":
            raise NotImplementedError(
                "control='batched' (core/control.py) is ported with the "
                "batched-control-plane slice; use control='host'")
        if control != "host":
            raise ValueError(f"unknown control plane {control!r}")
        if policy not in POLICY_NAMES:
            raise KeyError(policy)
        defense = cfg.defense if defense is None else defense
        if defense != "none":
            raise NotImplementedError(
                f"defense {defense!r}: the defense plane is ported with "
                "its own slice")
        if cfg.population is not None or cfg.mode != "sync":
            raise NotImplementedError(
                "the population cut and async mode are not ported yet")
        if len(clients) != cfg.n_population:
            raise ValueError(f"{len(clients)} clients for "
                             f"{cfg.n_population} UEs")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.task = as_task(task if task is not None else cfg.task)
        self.clients = clients
        self.test = test
        self.rng = rng
        self.policy = policy
        self.lr = self.task.default_lr if lr is None else lr
        self.adaptive_omega = adaptive_omega
        self.scenario = (scenario if scenario is not None
                         else AttackScenario("legacy"))
        watch = self.scenario.watch
        self.watch_class = watch[0] if watch else None
        self.watch_target = watch[1] if watch else None
        self.engine = engine
        self.batch_size = (self.task.batch_size if batch_size is None
                           else batch_size)
        self.pad_to = pad_to
        self.n_buckets = n_buckets

        # host RNG, the stream of record: the same draws, in the same order,
        # as the JAX package's server — positions, then the init seed, then
        # the CPU clocks
        self.wireless = WirelessModel(cfg, rng)
        self.reputation = ReputationTracker(cfg)
        seed = int(rng.integers(1 << 31))
        self.params = self.task.init_params(
            torch.Generator().manual_seed(seed), self.device)
        self.ages = np.ones(cfg.n_population)   # rounds since last selected
        self.cpu_hz = rng.uniform(cfg.cpu_hz_min, cfg.cpu_hz_max,
                                  cfg.n_population)
        self.sizes = np.array([c.size for c in clients], float)
        # malicious-set layout for the activity schedule
        self._mal_mask = np.array([c.malicious for c in clients])
        mal_ids = np.flatnonzero(self._mal_mask)
        self._mal_rank = np.full(cfg.n_population, -1)
        self._mal_rank[mal_ids] = np.arange(mal_ids.size)
        # UEs report their quality metadata once; poisoned data is what the
        # UE *believes*, so the report reflects the attack
        self.divs = np.array([self.task.gini(c.data) for c in clients])
        self.histograms = [self.task.histogram(c.data) for c in clients]
        # Interpretation decision (DESIGN.md §2): Eq. 1's acc_test is
        # evaluated on the test units restricted to the classes a UE claims
        # to hold — otherwise the reputation punishes honest-but-skewed
        # (non-IID) UEs exactly as hard as poisoners.
        unit_labels = self.task.unit_labels(test)
        self._test_masks = [np.isin(unit_labels, np.flatnonzero(h > 0))
                            for h in self.histograms]
        self._test_mask_arr = np.stack(self._test_masks).astype(np.float32)
        self._ex = self.task.eval_inputs(test, self.device)
        self._ey = self.task.unit_targets(test, self.device)
        self._cohort_data: Optional[CohortData] = None   # built lazily
        self.pad_waste: List[float] = []   # per-round padded/real samples
        self.logs: List[RoundLog] = []

    # ------------------------------------------------------------------ #
    def _omega(self, round_t: int) -> Tuple[float, float]:
        """(w_rep, w_div) for this round — annealed under adaptive omega."""
        if self.adaptive_omega:
            return adaptive_weights(round_t, self.cfg.rounds, self.cfg)
        return self.cfg.omega_rep, self.cfg.omega_div

    def _values(self, round_t: int) -> np.ndarray:
        cfg = self.cfg
        I = diversity_index(self.divs, self.sizes, self.ages, cfg.gamma)
        return data_quality_value(self.reputation.values, I, cfg,
                                  omega=self._omega(round_t))

    def _schedule(self, values: np.ndarray) -> Schedule:
        cfg = self.cfg
        gains = self.wireless.draw_channels().gains
        t_train = self.wireless.train_time(self.sizes, self.cpu_hz)
        costs = self.wireless.cost(gains, t_train)
        if self.policy == "dqs":
            return dqs_schedule(values, costs, cfg)
        if self.policy == "random":
            return random_schedule(values, costs, cfg, self.rng)
        if self.policy == "best_channel":
            return best_channel_schedule(values, costs, cfg, gains)
        if self.policy == "max_count":
            return max_count_schedule(values, costs, cfg)
        # top_value: selection ignores the channel, but the logged
        # Schedule.cost reports the real Eq. 9 costs
        return top_value_schedule(values, costs, cfg, cfg.min_selected)

    def _schedule_round(self, t: int):
        """Alg. 1 lines 4-8: values -> schedule -> participant set.

        Returns (values, sched, sel, forced). ``forced`` marks a degenerate
        channel draw: no UE met the deadline, so the server forces the
        single highest-value UE to keep training alive.
        """
        values = self._values(t)
        sched = self._schedule(values)
        sel = sched.selected
        forced = False
        if sel.size == 0:
            # the logged selection describes the actual participant set
            k = int(np.argmax(values))
            sel = np.array([k])
            x = np.zeros(values.size, bool)
            x[k] = True
            alpha = np.zeros(values.size)
            alpha[k] = 1.0          # the forced UE gets the whole band
            sched = Schedule(x=x, alpha=alpha, cost=sched.cost,
                             value=values)
            forced = True
        return values, sched, sel, forced

    # ------------------------------------------------------------------ #
    # Per-cohort engines: both return the round's uploads WITHOUT
    # aggregating — (uploads, weights, acc_local, acc_test) where
    # ``uploads`` is a params list (loop) or the padded merged stack
    # (vectorized) and ``weights`` the aligned FedAvg sample counts.
    # ------------------------------------------------------------------ #
    def _active_malicious(self, t: int) -> np.ndarray:
        return self.scenario.schedule.active(t, self._mal_mask,
                                             self._mal_rank)

    def _run_cohort_loop(self, sel: np.ndarray, t: int):
        cfg = self.cfg
        # an inactive malicious UE trains on its clean twin this round
        active = self._active_malicious(t)
        reports = []
        for k in sel:
            c = self.clients[k]
            if c.clean is not None and not active[k]:
                c = dataclasses.replace(c, data=c.clean, clean=None)
            reports.append(self.task.local_train(
                c, self.params, cfg.local_epochs, self.lr,
                self.batch_size))
        acc_local = np.array([r.acc_local for r in reports])
        params_list = [r.params for r in reports]
        # server-side evaluation of every uploaded model (Alg. 1 line 14)
        acc_test = np.array([
            self.task.eval_units_loop(p, self.test, self._test_masks[k])
            for p, k in zip(params_list, sel)])
        weights = np.asarray([r.n_samples for r in reports], float)
        return params_list, weights, acc_local, acc_test

    def _ensure_cohort_data(self) -> CohortData:
        if self._cohort_data is None:
            self._cohort_data = build_cohort_data(
                self.clients, self._test_mask_arr, self.device,
                batch_size=self.batch_size, pad_to=self.pad_to,
                n_buckets=self.n_buckets)
        return self._cohort_data

    def _cohort_parts(self, sel: np.ndarray, t: int):
        """Split round ``t``'s cohort per size bucket.

        Yields ``(bucket, positions_in_sel, row_ids)``. A malicious UE whose
        data attack is INACTIVE in round t maps to its clean twin row. The
        row ids are padded to ``cohort.pad_count`` rows with the bucket's
        null client (mask all-zero -> training no-op).
        """
        cd = self._ensure_cohort_data()
        rows_of = cd.row_of
        if np.any(cd.clean_row_of >= 0):
            use_clean = ~self._active_malicious(t) & (cd.clean_row_of >= 0)
            rows_of = np.where(use_clean, cd.clean_row_of, cd.row_of)
        for b, bkt in enumerate(cd.buckets):
            pos = np.flatnonzero(cd.bucket_of[sel] == b)
            if pos.size == 0:
                continue
            rows = rows_of[sel[pos]]
            n_pad = cohort.pad_count(pos.size, self._N_BUCKET)
            rows = np.concatenate(
                [rows, np.full(n_pad - pos.size, bkt["null"], rows.dtype)])
            yield bkt, pos, rows

    def _run_cohort_vectorized(self, sel: np.ndarray, t: int):
        cfg = self.cfg
        cd = self._ensure_cohort_data()
        n = sel.size
        parts, pad_slots = [], 0
        for bkt, pos, rows in self._cohort_parts(sel, t):
            idx = torch.as_tensor(rows, device=self.device)
            data = {f: a.index_select(0, idx)
                    for f, a in bkt["data"].items()}
            ms = bkt["mask"].index_select(0, idx)
            stacked_b, acc_b = cohort.cohort_train(
                self.task, self.params, data, ms, self.lr,
                cfg.local_epochs, self.batch_size)
            parts.append((pos,
                          {k: v[:pos.size] for k, v in stacked_b.items()},
                          acc_b[:pos.size].cpu().numpy().astype(float)))
            pad_slots += rows.size * bkt["level"]
        # merge the buckets back into selection order: FedAvg then
        # accumulates in the loop oracle's order
        order = np.concatenate([p[0] for p in parts])
        inv = np.argsort(order, kind="stable")
        stacked = cohort.merge_stacks([p[1] for p in parts], inv)
        acc_local = np.concatenate([p[2] for p in parts])[inv]
        self.pad_waste.append(
            float(pad_slots) / max(float(cd.sizes[sel].sum()), 1.0))

        # evaluate + aggregate once on the merged stack, zero-padded to a
        # stable row count (null rows score 0 under an all-zero mask and
        # contribute exactly 0 with weight 0)
        n_pad = cohort.pad_count(n, self._N_BUCKET)
        stacked_p = cohort.pad_stacked(stacked, n_pad)
        eval_rows = np.concatenate(
            [sel, np.full(n_pad - n, len(self.clients), sel.dtype)])
        masks = cd.mask_dev.index_select(
            0, torch.as_tensor(eval_rows, device=self.device))
        acc_test = cohort.cohort_eval(self.task, stacked_p, self._ex,
                                      self._ey, masks)
        acc_test = acc_test.cpu().numpy().astype(float)[:n]
        weights = np.zeros(n_pad)
        weights[:n] = cd.sizes[sel]
        return stacked_p, weights, acc_local, acc_test

    def _train_cohort(self, sel: np.ndarray, t: int):
        if self.engine == "vectorized":
            return self._run_cohort_vectorized(sel, t)
        return self._run_cohort_loop(sel, t)

    def _aggregate_uploads(self, uploads, weights: np.ndarray) -> None:
        """FedAvg into ``self.params`` — one ``weighted_aggregate`` launch
        in either engine."""
        if self.engine == "vectorized":
            self.params = fedavg_stacked(uploads, weights)
        else:
            self.params = fedavg(uploads, list(weights))

    def _global_metrics(self) -> Tuple[float, float, float, float]:
        """(global unit accuracy, global loss, watch accuracy, attack
        success rate) of the current params."""
        return self.task.global_metrics(self.params, self.test, self._ex,
                                        self._ey, self.watch_class,
                                        self.watch_target)

    def _finalize_round(self, t: int, values, sched, sel, forced,
                        acc_local, acc_test, g_acc, g_loss, src_acc,
                        atk_succ) -> RoundLog:
        """Alg. 1 lines 15-16 + logging: reputation, staleness, RoundLog."""
        self.reputation.update(sel, acc_local, acc_test)
        # ages: selected reset, others grow (staleness of Eq. 2)
        self.ages += 1.0
        self.ages[sel] = 1.0
        log = RoundLog(
            round=t, selected=sel, global_acc=g_acc, global_loss=g_loss,
            n_malicious_selected=sum(self.clients[k].malicious for k in sel),
            objective=0.0 if forced else sched.objective(),
            values=values.copy(),
            reputations=self.reputation.values.copy(), source_acc=src_acc,
            attack_success=atk_succ,
            rep_gap=reputation_gap(self.reputation.values, self._mal_mask),
            forced=forced)
        self.logs.append(log)
        return log

    def run_round(self, t: int) -> RoundLog:
        values, sched, sel, forced = self._schedule_round(t)
        uploads, weights, acc_local, acc_test = self._train_cohort(sel, t)
        self._aggregate_uploads(uploads, weights)
        g_acc, g_loss, src_acc, atk_succ = self._global_metrics()
        return self._finalize_round(t, values, sched, sel, forced,
                                    acc_local, acc_test, g_acc, g_loss,
                                    src_acc, atk_succ)

    def run(self, rounds: Optional[int] = None) -> List[RoundLog]:
        for t in range(rounds or self.cfg.rounds):
            self.run_round(t)
        return self.logs
