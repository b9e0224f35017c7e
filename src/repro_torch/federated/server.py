"""FEEL server (Alg. 1): per-round schedule -> local train -> evaluate ->
reputation update -> FedAvg aggregate.

The server sees only what the paper allows it to see: dataset *metadata*
(size, symbol histogram for the diversity index, staleness), self-reported
local accuracies, uploaded models evaluated on the public test set, and
channel state. It never touches raw client data.

The control plane (values -> Eq. 9 costs -> Alg. 2 selection -> Eq. 1
reputation) draws from the host RNG — the stream of record — at exactly the
points the JAX package's server does, and runs in float64 as
``control="batched"`` (default: ``core/control.py``'s batched plane for this
one run, on ``device`` for a CUDA device and as batched numpy on the CPU;
the sweep runner stacks all its runs into the same plane) or
``control="host"`` (the sequential numpy oracle). The data plane runs on
``device``:

    "vectorized" (default) — the cohort engine (federated/cohort.py): the
        round's scheduled UEs are split into ``n_buckets`` size buckets,
        each padded only to its own quantized max_samples level, each bucket
        trains at once with an explicit client axis, the per-bucket stacks
        are merged back into selection order, and evaluation + aggregation
        run once on the merged stack — one ``fedavg_stacked`` call, hence
        one ``weighted_aggregate`` kernel launch per round.
    "loop" — the sequential per-client loop, kept as the correctness oracle.

Threat model: the server takes a ``core.attacks.AttackScenario``; its data
component is baked into the clients by the partition, and its model/report
components apply to the merged cohort stack through one masked
``torch.where`` per leaf (``_apply_attacks``) on the scenario's activity
schedule — ``_apply_attacks_loop`` keeps the per-client dispatch as its
parity oracle, and the loop engine applies the same attacks per client.

Defense plane (``core/defenses.py``): the policy's robust aggregator
replaces FedAvg in ``_aggregate_uploads`` — for both engines, on
``device``: the trimmed mean and median through the ``robust_aggregate``
kernel, norm clipping and Krum through the ``weighted_aggregate`` kernel —
and its validation
detector scores every upload on a held-out split in one extra batched
evaluation, feeding a trust penalty into Eq. 1 in ``_finalize_round``.

The padded device-resident client arrays live in a ``CohortData`` that
several servers on the same (dataset, partition) can share — the batched
sweep runner (``federated/simulation.py::run_sweep``) builds it once per
(task, seed, data attack) and hands it to every run on it.

Under a population cut (``cfg.population = N > K``) every per-UE control
array spans the N candidates and the batched control plane schedules
through the top-M prefilter (core/population.py). In async mode the event
engine (federated/async_engine.py) drives the round phases itself and
masks the UEs with an upload in flight (``unavailable``).

Telemetry (``obs/trace.py``): every round phase runs inside a span of the
reference's name (``round``, ``schedule``, ``train``, ``train.bucket``,
``attack.apply``, ``eval``, ``eval.validation``, ``defense.aggregate``,
``defense.detect``, ``finalize``, ``eval.global``), with the
``train.pad_waste`` and ``train.bucket_occupancy`` observations and the
analytic ``est_flops`` / ``est_bytes`` attributes of ``_schedule_estimates``
and ``_train_estimates``. Every attribute is a value the host already
holds, so tracing adds no host read of a device value, and with tracing
off each span is the shared no-op.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FeelConfig
from repro_torch.core import attacks as atk
from repro_torch.core import control as ctl
from repro_torch.core import defenses as dfs
from repro_torch.core import population
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
from repro_torch.federated.aggregation import fedavg_stacked
from repro_torch.federated.task import FeelTask, as_task
from repro_torch.obs import trace
from repro_torch.random import PRNGKey


@dataclasses.dataclass
class RoundLog:
    round: int
    selected: np.ndarray
    global_acc: float
    n_malicious_selected: int
    objective: float
    values: np.ndarray
    reputations: np.ndarray
    # task-defined global loss metric: the LM's held-out per-token
    # cross-entropy (NaN for the MNIST MLP)
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
    # defense-plane metrics: norm-clipped / aggregation-rejected upload
    # counts, validation-detector flags, and detection precision/recall
    # against the ground-truth malicious mask (metrics only)
    n_clipped: int = 0
    n_rejected: int = 0
    n_flagged: int = 0
    det_precision: float = float("nan")
    det_recall: float = float("nan")


@dataclasses.dataclass
class CohortData:
    """Device-resident padded client layout for the vectorized engine.

    ``buckets[b]`` holds one size bucket's per-sample tensors (``data``:
    the task's ``sample_arrays`` fields, integer fields as int64 — ``x``
    float32 and ``y`` for the MLP, ``tokens`` for the LM) and validity
    mask, laid out as [real client rows | clean twin rows | one all-zero
    "null client" row at index ``null``] — cohort-size padding gathers the
    null row for a strict training no-op. The twin rows hold the
    PRE-POISON data of data-attacked clients (``ClientData.clean``): a
    round-scheduled data attack gathers a malicious UE's twin row in its
    off rounds.
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
        data = {f: a if a.is_floating_point() else a.long()
                for f, a in data.items()}
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
    control: 'batched' (default) | 'host' — the control plane (see module
    docstring).
    device: where the data plane runs; None means 'cuda', which raises when
    CUDA is absent (pass 'cpu' to run on the CPU).
    scenario: an ``core.attacks.AttackScenario`` (or registry name) — the
    threat model. Its data component must already be baked into
    ``clients``; the server applies the model/report components on the
    scenario's activity schedule and tracks the watched (source, target)
    metrics. It supersedes the legacy ``model_poison`` (a
    ``core.poisoning.ModelPoisonAttack``), ``lie_boost`` and ``watch_class``
    knobs, which are normalised into an equivalent scenario.
    defense: a ``core.defenses.DefensePolicy`` (or registry name); None
    defers to ``cfg.defense``.
    ``lr``/``batch_size`` default to the task's protocol values when None.
    n_buckets: number of max_samples size buckets for the vectorized
    engine; cohort_data: a ``CohortData`` shared with other servers on the
    same clients (None: built on first use). ``params`` may be replaced
    after construction (the parity tests inject the JAX package's initial
    params that way).

    The underscore round-phase methods (_schedule_round, _cohort_parts,
    _gather_bucket, _merge_cohort, _apply_attacks, _eval_masks,
    _aggregate_cohort, _finalize_round, _log_round, draw_control_inputs)
    are a semi-public contract: the batched sweep runner
    (federated/simulation.py) interleaves them across runs.
    """

    _N_BUCKET = 8   # cohort sizes are padded to a multiple of this with
                    # zero-weight null clients (stable shapes)

    def __init__(self, cfg: FeelConfig, clients: List[ClientData],
                 test, rng: np.random.Generator,
                 policy: str = "dqs", lr: Optional[float] = None,
                 adaptive_omega: bool = False, lie_boost: float = 0.0,
                 watch_class: Optional[int] = None, model_poison=None,
                 engine: str = "vectorized",
                 batch_size: Optional[int] = None,
                 pad_to: Optional[int] = None, n_buckets: int = 3,
                 cohort_data: Optional[CohortData] = None,
                 control: str = "batched",
                 scenario=None, defense=None,
                 task: Optional[FeelTask] = None,
                 device: DeviceLike = None):
        if engine not in ("vectorized", "loop"):
            raise ValueError(f"unknown engine {engine!r}")
        if control not in ("batched", "host"):
            raise ValueError(f"unknown control plane {control!r}")
        self.control = control
        if policy not in POLICY_NAMES:
            raise KeyError(policy)
        if scenario is not None and (model_poison is not None or lie_boost
                                     or watch_class is not None):
            raise ValueError(
                "scenario supersedes the legacy model_poison/lie_boost/"
                "watch_class knobs (set AttackScenario.watch instead)")
        self.defense = dfs.as_defense(cfg.defense if defense is None
                                      else defense)
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
        self.scenario = (atk.as_scenario(scenario) if scenario is not None
                         else atk.legacy_scenario(
                             None, model_poison_scale=(
                                 None if model_poison is None
                                 else model_poison.scale),
                             lie_boost_val=lie_boost))
        # metrics watch pair: an explicit watch_class wins (legacy callers),
        # else the scenario's (source, target)
        watch = self.scenario.watch
        self.watch_class = (watch_class if watch_class is not None
                            else (watch[0] if watch else None))
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
        self.params = self.task.init_params(PRNGKey(seed, self.device),
                                            self.device)
        self.ages = np.ones(cfg.n_population)   # rounds since last selected
        self.cpu_hz = rng.uniform(cfg.cpu_hz_min, cfg.cpu_hz_max,
                                  cfg.n_population)
        self.sizes = np.array([c.size for c in clients], float)
        # malicious-set layout for the activity schedule
        self._mal_mask = np.array([c.malicious for c in clients])
        mal_ids = np.flatnonzero(self._mal_mask)
        self._mal_rank = np.full(cfg.n_population, -1)
        self._mal_rank[mal_ids] = np.arange(mal_ids.size)
        # stale free-riders replay the global model from ``staleness``
        # rounds ago; keep exactly that much history (None otherwise)
        st = self.scenario.model.staleness if self.scenario.model else 0
        self._param_hist = (collections.deque(maxlen=st + 1) if st > 0
                            else None)
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
        # defense plane: the validation detector scores every upload on a
        # held-out split (the units of the first n_val test rows),
        # restricted per UE to the classes it claims to hold — the same
        # masking argument as Eq. 1's acc_test
        det = self.defense.detector
        if det is not None:
            self._n_val = min(det.n_val, len(test.y))
            val_rows = self.task.unit_rows(test) < self._n_val
            self._val_masks = [m & val_rows for m in self._test_masks]
            arr = self._test_mask_arr * val_rows.astype(np.float32)[None]
            self._val_mask_dev = torch.as_tensor(
                np.concatenate([arr, np.zeros_like(arr[:1])]),
                device=self.device)
        self._def_stats = dfs.DefenseStats()   # refreshed every round
        self._cohort_data = cohort_data   # shared, or built on first use
        # batched control state of this one run, built on first use (the
        # sweep runner builds one for all its runs instead)
        self._ctrl: Optional[ctl.ControlState] = None
        # async busy mask (federated/async_engine.py): these UEs have an
        # upload in flight and must not be scheduled again. Their channel
        # gains are zeroed for the draw, an arithmetic mask and no RNG
        # draw, so the host stream of record is untouched. None in sync
        # mode.
        self.unavailable: Optional[np.ndarray] = None
        self.pad_waste: List[float] = []   # per-round padded/real samples
        self.logs: List[RoundLog] = []
        self._n_params: Optional[int] = None   # telemetry-only param count

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

    def _mask_unavailable(self, gains: np.ndarray) -> np.ndarray:
        """Zero the gains of busy UEs: a zero gain makes Eq. 9 infeasible
        (cost K + 1), so every channel-aware packing skips them. The async
        engine drops busy UEs from channel-blind selections (top_value,
        the forced rewrite) itself."""
        if self.unavailable is not None:
            gains = np.where(self.unavailable, 0.0, gains)
        return gains

    def _schedule(self, values: np.ndarray) -> Schedule:
        cfg = self.cfg
        gains = self._mask_unavailable(self.wireless.draw_channels().gains)
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
        with trace.span("schedule") as sp:
            if self.control == "batched":
                out = self._schedule_round_batched(t)
            else:
                out = self._schedule_round_host(t)
            if trace.enabled():
                values, sched, sel, forced = out
                sp.set(t=t, n_selected=int(sel.size), forced=bool(forced),
                       **self._schedule_estimates())
            return out

    def _schedule_round_host(self, t: int):
        """The sequential numpy oracle of ``_schedule_round``."""
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

    def _control_state(self) -> ctl.ControlState:
        if self._ctrl is None:
            self._ctrl = ctl.ControlState.from_servers([self])
        return self._ctrl

    def draw_control_inputs(self) -> Tuple[np.ndarray, np.ndarray]:
        """(gains, rand_rank) for one round, drawn from THIS server's RNG
        in the oracle's order: the channel draw first, then — for the
        ``random`` policy only — the packing permutation. The batched plane
        is a deterministic function of these draws, which keeps every
        run's stream equal to its sequential twin's. Busy UEs' gains come
        back zeroed (``_mask_unavailable``)."""
        gains = self._mask_unavailable(self.wireless.draw_channels().gains)
        if self.policy == "random":
            rand_rank = np.argsort(
                self.rng.permutation(self.cfg.n_population))
        else:
            rand_rank = np.arange(self.cfg.n_population)
        return gains, rand_rank

    def _schedule_round_batched(self, t: int):
        st = self._control_state()
        st.pull([self])
        gains, rand_rank = self.draw_control_inputs()
        w_rep, w_div = self._omega(t)
        if self.cfg.population is not None:
            # population cut: the top-M prefilter, whose selection is the
            # exact one (core/population.py)
            x, alpha, costs, values, forced, _ = \
                population.prefilter_schedule_runs(
                    st, gains[None], rand_rank[None], np.array([w_rep]),
                    np.array([w_div]))
        else:
            x, alpha, costs, values, forced = ctl.schedule_runs(
                st, gains[None], rand_rank[None], np.array([w_rep]),
                np.array([w_div]))
        sched = Schedule(x=x[0], alpha=alpha[0], cost=costs[0],
                         value=values[0])
        return values[0], sched, sched.selected, bool(forced[0])

    # ------------------------------------------------------------------ #
    # Per-cohort engines: both return the round's uploads WITHOUT
    # aggregating — (uploads, weights, acc_local, acc_test, acc_val) where
    # ``uploads`` is a params list (loop) or the padded merged stack
    # (vectorized), ``weights`` the aligned FedAvg sample counts and
    # ``acc_val`` the detector's (2, n) validation scores (None without a
    # detector).
    # ------------------------------------------------------------------ #
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

        # attacks, per client — the loop engine is the oracle of the
        # masked stacked application
        scn = self.scenario
        ref = self._attack_ref_params()
        mal = active[sel]
        if scn.model is not None:
            params_list = [scn.model.apply_loop(self.params, p, ref)
                           if m else p for p, m in zip(params_list, mal)]
        if scn.report is not None:
            acc_local = scn.report.apply(acc_local, mal)

        # server-side evaluation of every uploaded model (Alg. 1 line 14)
        acc_test = np.array([
            self.task.eval_units_loop(p, self.test, self._test_masks[k])
            for p, k in zip(params_list, sel)])

        # defense detector: every upload AND the start-of-round global
        # model on each UE's masked validation split
        acc_val = None
        if self.defense.detector is not None:
            acc_val = np.zeros((2, len(params_list)))
            for i, (p, k) in enumerate(zip(params_list, sel)):
                m = self._val_masks[k]
                if m.any():
                    acc_val[0, i] = self.task.eval_units_loop(
                        p, self.test, m)
                    acc_val[1, i] = self.task.eval_units_loop(
                        self.params, self.test, m)
        weights = np.asarray([r.n_samples for r in reports], float)
        return params_list, weights, acc_local, acc_test, acc_val

    def _ensure_cohort_data(self) -> CohortData:
        if self._cohort_data is None:
            self._cohort_data = build_cohort_data(
                self.clients, self._test_mask_arr, self.device,
                batch_size=self.batch_size, pad_to=self.pad_to,
                n_buckets=self.n_buckets)
        return self._cohort_data

    def _cohort_parts(self, sel: np.ndarray, t: int, pad: bool = True):
        """Split round ``t``'s cohort per size bucket.

        Yields ``(bucket, positions_in_sel, row_ids)``. A malicious UE whose
        data attack is INACTIVE in round t maps to its clean twin row. With
        ``pad`` the row ids are padded to ``cohort.pad_count`` rows with the
        bucket's null client (mask all-zero -> training no-op); the sweep
        runner passes ``pad=False`` and pads its cross-run group once.
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
            if pad:
                n_pad = cohort.pad_count(pos.size, self._N_BUCKET)
                rows = np.concatenate(
                    [rows, np.full(n_pad - pos.size, bkt["null"],
                                   rows.dtype)])
            yield bkt, pos, rows

    def _gather_bucket(self, bkt: Dict, rows: np.ndarray):
        """Device-side gather of a bucket's (data, mask) rows."""
        idx = torch.as_tensor(rows, device=self.device)
        return ({f: a.index_select(0, idx) for f, a in bkt["data"].items()},
                bkt["mask"].index_select(0, idx))

    @staticmethod
    def _merge_cohort(parts):
        """Merge per-bucket results (pos, stacked_real_rows, acc_real) back
        into selection order: FedAvg then accumulates in the loop oracle's
        order."""
        order = np.concatenate([p[0] for p in parts])
        inv = np.argsort(order, kind="stable")
        stacked = cohort.merge_stacks([p[1] for p in parts], inv)
        acc_local = np.concatenate([p[2] for p in parts])[inv]
        return stacked, acc_local

    def _active_malicious(self, t: int) -> np.ndarray:
        """(K,) bool — UEs whose malicious behaviour is ACTIVE in round t
        (gates the data, model and report components)."""
        return self.scenario.schedule.active(t, self._mal_mask,
                                             self._mal_rank)

    def _attack_ref_params(self):
        """Reference params for the model attack: the current global
        model, or — for stale free-riders — the global model from
        ``staleness`` rounds ago. Called exactly once per round (it
        advances the history)."""
        if self._param_hist is None:
            return self.params
        self._param_hist.append(self.params)     # start-of-round params
        return self._param_hist[0]

    def _apply_attacks(self, sel, stacked, acc_local, t):
        """Model poisoning + dishonest reporting on the merged stack: one
        masked ``torch.where`` per leaf over the malicious rows
        (``ModelAttack.apply_stacked``) — no per-client dispatch."""
        scn = self.scenario
        with trace.span("attack.apply") as sp:
            ref = self._attack_ref_params()
            mal = self._active_malicious(t)[sel]
            if scn.model is not None and mal.any():
                stacked = scn.model.apply_stacked(stacked, self.params, mal,
                                                  ref)
            if scn.report is not None:
                acc_local = scn.report.apply(acc_local, mal)
            if trace.enabled():
                sp.set(scenario=scn.name, n_active=int(mal.sum()))
        return stacked, acc_local

    def _apply_attacks_loop(self, sel, stacked, acc_local, t):
        """The per-malicious-client dispatch loop, kept only as the parity
        oracle of ``_apply_attacks``."""
        scn = self.scenario
        ref = self._attack_ref_params()
        mal = self._active_malicious(t)[sel]
        if scn.model is not None and mal.any():
            for i in np.flatnonzero(mal):
                poisoned = scn.model.apply_loop(
                    self.params, cohort.unstack(stacked, int(i)), ref)
                idx = torch.tensor([int(i)], device=self.device)
                stacked = {k: v.index_copy(0, idx, poisoned[k][None])
                           for k, v in stacked.items()}
        if scn.report is not None:
            acc_local = scn.report.apply(acc_local, mal)
        return stacked, acc_local

    def _pad_rows(self, sel: np.ndarray, n_pad: int) -> torch.Tensor:
        """Row ids of a padded merged stack into the (K+1, U) mask tables:
        the selection, then the all-zero null row."""
        return torch.as_tensor(np.concatenate(
            [sel, np.full(n_pad - sel.size, len(self.clients), sel.dtype)]),
            device=self.device)

    def _eval_masks(self, sel: np.ndarray, n_pad: int) -> torch.Tensor:
        """(n_pad, U) per-UE eval unit masks for a padded merged stack."""
        return self._ensure_cohort_data().mask_dev.index_select(
            0, self._pad_rows(sel, n_pad))

    def _val_eval_masks(self, sel: np.ndarray, n_pad: int) -> torch.Tensor:
        """(n_pad, U) per-UE class-masked validation-split eval masks."""
        return self._val_mask_dev.index_select(0, self._pad_rows(sel, n_pad))

    def _cohort_weights(self, sel: np.ndarray, stacked_p) -> np.ndarray:
        """FedAvg sample-count weights for a padded merged stack: real rows
        carry their dataset size, pad rows weight 0."""
        weights = np.zeros(next(iter(stacked_p.values())).shape[0])
        weights[:sel.size] = self._ensure_cohort_data().sizes[sel]
        return weights

    def _run_cohort_vectorized(self, sel: np.ndarray, t: int):
        cfg = self.cfg
        cd = self._ensure_cohort_data()
        n = sel.size
        parts, pad_slots = [], 0
        for bkt, pos, rows in self._cohort_parts(sel, t):
            data, ms = self._gather_bucket(bkt, rows)
            with trace.span("train.bucket") as bsp:
                probe0 = trace.kernels_loaded() if trace.enabled() else 0
                stacked_b, acc_b = cohort.cohort_train(
                    self.task, self.params, data, ms, self.lr,
                    cfg.local_epochs, self.batch_size)
                if trace.enabled():
                    bsp.set(level=int(bkt["level"]), rows=int(rows.size),
                            real=int(pos.size),
                            compiled=trace.kernels_loaded() > probe0)
                    trace.observe("train.bucket_occupancy",
                                  pos.size / rows.size)
            parts.append((pos,
                          {k: v[:pos.size] for k, v in stacked_b.items()},
                          acc_b[:pos.size].cpu().numpy().astype(float)))
            pad_slots += rows.size * bkt["level"]
        stacked, acc_local = self._merge_cohort(parts)
        self.pad_waste.append(
            float(pad_slots) / max(float(cd.sizes[sel].sum()), 1.0))
        if trace.enabled():
            trace.observe("train.pad_waste", self.pad_waste[-1])

        stacked, acc_local = self._apply_attacks(sel, stacked, acc_local, t)

        # evaluate + aggregate once on the merged stack, zero-padded to a
        # stable row count (null rows score 0 under an all-zero mask and
        # contribute exactly 0 with weight 0)
        n_pad = cohort.pad_count(n, self._N_BUCKET)
        stacked_p = cohort.pad_stacked(stacked, n_pad)
        with trace.span("eval") as esp:
            probe0 = trace.kernels_loaded() if trace.enabled() else 0
            acc_test = cohort.cohort_eval(self.task, stacked_p, self._ex,
                                          self._ey,
                                          self._eval_masks(sel, n_pad))
            acc_test = acc_test.cpu().numpy().astype(float)[:n]
            if trace.enabled():
                esp.set(rows=int(n_pad),
                        compiled=trace.kernels_loaded() > probe0)
        acc_val = self._eval_validation(stacked_p, sel)
        return (stacked_p, self._cohort_weights(sel, stacked_p), acc_local,
                acc_test, acc_val)

    def _eval_validation(self, stacked_p, sel: np.ndarray
                         ) -> Optional[np.ndarray]:
        """Defense detector: the ONE extra batched eval — every uploaded
        model AND the start-of-round global model scored on the held-out
        validation split restricted to each UE's claimed classes; (2, n):
        uploads row, global row."""
        if self.defense.detector is None:
            return None
        with trace.span("eval.validation") as sp:
            n = sel.size
            n_pad = next(iter(stacked_p.values())).shape[0]
            vm = self._val_eval_masks(sel, n_pad)
            both = cohort.merge_stacks(
                [stacked_p, cohort.broadcast_params(self.params, n_pad)])
            acc = cohort.cohort_eval(self.task, both, self._ex, self._ey,
                                     torch.cat([vm, vm]))
            acc = acc.cpu().numpy().astype(float)
            if trace.enabled():
                sp.set(rows=int(2 * n_pad))
            return np.stack([acc[:n], acc[n_pad:n_pad + n]])

    def _train_cohort(self, sel: np.ndarray, t: int):
        """(uploads, weights, acc_local, acc_test, acc_val) of the round's
        cohort — no aggregation (see the engines' section comment)."""
        with trace.span("train") as sp:
            if trace.enabled():
                sp.set(t=t, engine=self.engine, n=int(sel.size),
                       **self._train_estimates(sel))
            if self.engine == "vectorized":
                return self._run_cohort_vectorized(sel, t)
            return self._run_cohort_loop(sel, t)

    def _aggregate_cohort(self, sel: np.ndarray, stacked_p,
                          weights: Optional[np.ndarray] = None) -> None:
        """Aggregate a stacked cohort (the n real rows first, any padding
        weight 0) into ``self.params`` on ``device``: undefended, FedAvg
        (one ``weighted_aggregate`` launch); under a robust aggregator,
        ``defenses.aggregate_stacked`` over the (N, P) layout (the trimmed
        mean and median through ``robust_aggregate``), its stats landing in
        ``_def_stats`` for ``_log_round``. ``weights`` None means the
        sample counts (``_cohort_weights``) — the sweep runner's form."""
        if weights is None:
            weights = self._cohort_weights(sel, stacked_p)
        agg = self.defense.aggregator
        with trace.span("defense.aggregate") as sp:
            probe0 = trace.kernels_loaded() if trace.enabled() else 0
            if agg is None:
                self._def_stats = dfs.DefenseStats()
                self.params = fedavg_stacked(stacked_p, weights)
            else:
                self.params, self._def_stats = dfs.aggregate_stacked(
                    agg, stacked_p, weights, self.params, sel.size,
                    self.cfg.n_malicious)
            if trace.enabled():
                sp.set(defense=self.defense.name, n=int(sel.size),
                       compiled=trace.kernels_loaded() > probe0)

    def _aggregate_uploads(self, sel: np.ndarray, uploads,
                           weights: np.ndarray) -> None:
        """Aggregate a cohort's uploads into ``self.params`` — the single
        write point of both engines. ``uploads`` is what ``_train_cohort``
        returned (params list / padded stack), ``weights`` the aligned
        FedAvg sample counts. The loop engine's list is stacked first, so
        both engines aggregate through ``_aggregate_cohort``."""
        if self.engine == "loop":
            uploads = {k: torch.stack([u[k] for u in uploads])
                       for k in uploads[0]}
        self._aggregate_cohort(sel, uploads, weights)

    def _detect(self, sel: np.ndarray, acc_val) -> Optional[np.ndarray]:
        """Validation-detector phase: anomaly scores -> Eq. 1 trust
        penalties (returned, aligned with ``sel``) + detection metrics
        against the ground-truth malicious mask (into ``_def_stats``,
        metrics only)."""
        det = self.defense.detector
        if det is None or acc_val is None or sel.size == 0:
            return None
        with trace.span("defense.detect") as sp:
            anomaly = det.anomaly(acc_val)
            flags = anomaly > 0
            st = self._def_stats
            st.n_flagged = int(flags.sum())
            st.det_precision, st.det_recall = dfs.detection_stats(
                flags, self._mal_mask[sel])
            if trace.enabled():
                sp.set(n_flagged=st.n_flagged)
            return det.weight * anomaly

    def _global_metrics(self) -> Tuple[float, float, float, float]:
        """(global unit accuracy, global loss, watch accuracy, attack
        success rate) of the current params."""
        with trace.span("eval.global"):
            return self.task.global_metrics(self.params, self.test,
                                            self._ex, self._ey,
                                            self.watch_class,
                                            self.watch_target)

    def _global_loss(self) -> float:
        """The task's global loss metric alone (NaN for a task without
        one); the stacked sweep computes the accuracies in its batched
        eval and needs only this extra."""
        loss = self.task.eval_loss(self.params, self._ex)
        return float("nan") if loss is None else float(loss)

    def _finalize_round(self, t: int, values, sched, sel, forced,
                        acc_local, acc_test, g_acc, src_acc,
                        atk_succ=float("nan"), acc_val=None,
                        g_loss=float("nan")) -> RoundLog:
        """Alg. 1 lines 15-16 + logging: detector penalty, reputation,
        staleness, RoundLog."""
        with trace.span("finalize"):
            penalty = self._detect(sel, acc_val)
            if self.control == "batched":
                st = self._control_state()
                st.pull([self])
                ctl.finalize_runs(st, [sel], [acc_local], [acc_test],
                                  penalties=[penalty])
                st.push([self])
            else:
                self.reputation.update(sel, acc_local, acc_test,
                                       penalty=penalty)
                # ages: selected reset, others grow (staleness of Eq. 2)
                self.ages += 1.0
                self.ages[sel] = 1.0
            return self._log_round(t, values, sched, sel, forced, g_acc,
                                   src_acc, atk_succ, g_loss)

    def _log_round(self, t: int, values, sched, sel, forced, g_acc,
                   src_acc, atk_succ=float("nan"),
                   g_loss=float("nan")) -> RoundLog:
        """Append the RoundLog of a finalized round (reputations and ages
        already updated — the sweep runner updates every run in one
        ``control.finalize_runs`` call, then logs per run)."""
        ds = self._def_stats
        log = RoundLog(
            round=t, selected=sel, global_acc=g_acc, global_loss=g_loss,
            n_malicious_selected=sum(self.clients[k].malicious for k in sel),
            objective=0.0 if forced else sched.objective(),
            values=values.copy(),
            reputations=self.reputation.values.copy(), source_acc=src_acc,
            attack_success=atk_succ,
            rep_gap=atk.reputation_gap(self.reputation.values,
                                       self._mal_mask),
            forced=forced,
            n_clipped=ds.n_clipped, n_rejected=ds.n_rejected,
            n_flagged=ds.n_flagged, det_precision=ds.det_precision,
            det_recall=ds.det_recall)
        self.logs.append(log)
        return log

    # ------------------------------------------------------------------ #
    # Telemetry-only analytic cost estimates: host arithmetic on sizes and
    # shapes, never a tensor value or an RNG draw; obs.report places the
    # schedule and train phases on the roofline with them.
    # ------------------------------------------------------------------ #
    def _param_count(self) -> int:
        if self._n_params is None:
            self._n_params = int(sum(v.numel() for v in self.params.values()))
        return self._n_params

    def _schedule_estimates(self) -> Dict[str, float]:
        """~flops/bytes of one control-plane round over N candidates:
        Eq. 2/3 elementwise (~40 flops a candidate), the ~64-probe Eq. 9
        bisection, the N log N pack sort; ~12 float64 passes over the (N,)
        control arrays."""
        n = float(self.cfg.n_population)
        flops = n * (40.0 + 64.0 * 8.0) + 2.0 * n * max(np.log2(n), 1.0)
        return {"est_flops": float(flops), "est_bytes": float(8.0 * n * 12.0)}

    def _train_estimates(self, sel: np.ndarray) -> Dict[str, float]:
        """~flops/bytes of the round's local training: 6*P a sample-step
        (forward 2P + backward 4P) over every real scheduled sample x
        epochs; ~3 float32 parameter passes a batch step."""
        p = float(self._param_count())
        steps = float(self.sizes[sel].sum()) * self.cfg.local_epochs
        batches = steps / max(self.batch_size, 1)
        return {"est_flops": 6.0 * p * steps,
                "est_bytes": 12.0 * p * max(batches, 1.0)}

    def run_round(self, t: int) -> RoundLog:
        with trace.span("round") as sp:
            if trace.enabled():
                sp.set(t=t, policy=self.policy, engine=self.engine,
                       control=self.control)
            values, sched, sel, forced = self._schedule_round(t)
            uploads, weights, acc_local, acc_test, acc_val = \
                self._train_cohort(sel, t)
            self._aggregate_uploads(sel, uploads, weights)
            g_acc, g_loss, src_acc, atk_succ = self._global_metrics()
            return self._finalize_round(t, values, sched, sel, forced,
                                        acc_local, acc_test, g_acc, src_acc,
                                        atk_succ, acc_val, g_loss)

    def run(self, rounds: Optional[int] = None) -> List[RoundLog]:
        if self.cfg.mode != "sync":
            raise ValueError("mode='async' runs through "
                             "federated.async_engine.AsyncFeelEngine")
        for t in range(rounds or self.cfg.rounds):
            self.run_round(t)
        return self.logs
