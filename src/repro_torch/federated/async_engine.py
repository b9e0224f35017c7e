"""Event-driven asynchronous FEEL engine (``mode="async"``).

The synchronous engine runs Alg. 1 as lockstep rounds: every scheduled UE's
upload lands before the next schedule is drawn. Real edge fleets trickle
in, and the Eq. 5-7 cost model already prices a per-UE latency (the
Eq. 6 train time plus the Eq. 7 upload time at the allocated bandwidth
fraction). This engine uses it as a clock:

    dispatch  — draw the next wave's schedule (the server's own
        ``_schedule_round``: either control plane, any policy) over the UEs
        with no upload in flight, train the whole wave at once from the
        CURRENT global params (the server's cohort engine, unchanged), and
        push one arrival event a scheduled UE at ``t_sim + latency``, the
        latency being (Eq. 6 train time + Eq. 7 upload time at the wave's
        Eq. 9 bandwidth split) times ``cfg.async_latency_scale``.
    arrive    — pop events in (arrival_time, dispatch_seq) order into the
        aggregation buffer, advancing the simulated clock.
    aggregate — on a trigger, aggregate the buffered uploads with weights
        ``sizes * decay**age`` (``control.staleness_discount``), the age
        being the current model version minus the version the upload was
        computed on: FedAvg through ``weighted_aggregate``, or the
        defense's robust aggregator. Aggregation bumps the model version,
        finalises Eq. 1 for exactly the aggregated UEs, logs a RoundLog and
        dispatches the next wave at once, so selection overlaps the
        training still in flight.

Triggers: ``cfg.async_buffer = B`` aggregates once B uploads are buffered
("buffer"); ``async_buffer=None`` waits for every upload in flight
("wave", the lockstep limit); ``cfg.async_deadline = d`` also flushes a
non-empty buffer at dispatch time + d sim-seconds ("deadline"); a
non-empty buffer with an empty event heap and no deadline flushes as a
"drain".

Busy masking: a UE with an upload in flight (heap or buffer) is not
scheduled again. Its channel gain is zeroed for the draw
(``FeelServer._mask_unavailable``), which makes Eq. 9 infeasible, so every
channel-aware packing skips it; channel-blind selections (``top_value``,
the forced rewrite) drop busy UEs at dispatch.

Zero-latency parity: at ``async_latency_scale = 0.0`` with wave triggers
every wave's uploads arrive at once in dispatch order (the event key
breaks ties by dispatch order, which is selection order), every age is 0
and ``decay**0 == 1.0`` exactly, so each aggregation gets the synchronous
round's rows, order and weights bit for bit, and ``mode="async"``
reproduces ``mode="sync"`` exactly, for both engines, both control planes
and both tasks.

The clock is SIMULATED: it advances only by the latency model on the
seeded channel and compute draws. The engine never reads the wall clock.
Telemetry: each dispatch and each aggregation is a span (``async.dispatch``,
``async.aggregate``) beside the ``async.heap_depth`` gauge and the
``async.upload_age`` observation, and while the event loop runs every span
is stamped with the simulated clock too (``trace.set_sim_clock``).
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import control as ctl
from repro_torch.federated import cohort
from repro_torch.federated.server import FeelServer, RoundLog
from repro_torch.obs import trace


@dataclasses.dataclass
class _Upload:
    """One upload in flight: its UE, the wave that produced it, the model
    version it was computed on and its per-UE results."""
    ue: int
    wave: int
    version: int            # model version of the params it trained on
    row: int                # row within the wave's stored uploads
    latency: float          # sim-seconds from dispatch to arrival
    acc_local: float
    acc_test: float
    acc_val: Optional[np.ndarray]   # (2,) detector column, None without one


@dataclasses.dataclass
class AggregationLog:
    """One aggregation's async metadata, beside the server's RoundLog."""
    version: int
    sim_time: float
    trigger: str            # 'wave' | 'buffer' | 'deadline' | 'drain'
    n_uploads: int
    ages: np.ndarray        # (n,) int staleness ages of the aggregated uploads
    discounts: np.ndarray   # (n,) staleness discounts applied to the weights
    waves: np.ndarray       # (n,) dispatch wave of each aggregated upload


class AsyncFeelEngine:
    """Drives a ``FeelServer`` through the event loop above. ``rounds``
    counts aggregations (model versions), the async analogue of rounds."""

    def __init__(self, server: FeelServer):
        if server.cfg.mode != "async":
            raise ValueError(f"AsyncFeelEngine needs cfg.mode='async', got "
                             f"{server.cfg.mode!r}")
        cfg = server.cfg
        self.server = server
        self.t_sim = 0.0                 # simulated clock (sim-seconds)
        self.version = 0                 # aggregations done == model version
        self.wave = 0                    # dispatches done
        self._seq = 0                    # global dispatch counter (tie-break)
        self._heap: List[Tuple[float, int, _Upload]] = []
        self._buffer: List[_Upload] = []
        # wave -> {"uploads", "weights", "left"}: a wave's trained stack is
        # kept until its last upload is aggregated (refcounted)
        self._store: Dict[int, Dict] = {}
        self._busy = np.zeros(cfg.n_population, bool)
        # the latest wave's (values, sched, forced): the schedule context
        # the next RoundLog reports
        self._plan = None
        self._dispatch_t = 0.0
        # Eq. 6 train times are round-invariant (sizes and clocks fixed)
        self._t_train = server.wireless.train_time(server.sizes,
                                                   server.cpu_hz)
        self.agg_logs: List[AggregationLog] = []

    # ------------------------------------------------------------------ #
    def _dispatch(self) -> None:
        """Schedule and train the next wave over the idle UEs and push its
        arrival events."""
        srv = self.server
        with trace.span("async.dispatch") as sp:
            srv.unavailable = (self._busy.copy() if self._busy.any()
                               else None)
            try:
                values, sched, sel, forced = srv._schedule_round(self.wave)
            finally:
                srv.unavailable = None
            # channel-blind selections ignore the zeroed gains: drop busy
            # UEs
            sel = sel[~self._busy[sel]]
            self._plan = (values, sched, forced)
            self._dispatch_t = self.t_sim
            wave = self.wave
            self.wave += 1
            if trace.enabled():
                sp.set(wave=wave, n_selected=int(sel.size),
                       n_busy=int(self._busy.sum()))
            if sel.size == 0:
                return
            uploads, weights, acc_local, acc_test, acc_val = \
                srv._train_cohort(sel, wave)
            # the Eq. 7 upload time on the wave's unmasked channel draw
            lat = (self._t_train[sel]
                   + srv.wireless.upload_time(srv.wireless.last_gains,
                                              sched.alpha)[sel]) \
                * srv.cfg.async_latency_scale
            if not np.all(np.isfinite(lat)):
                raise RuntimeError("non-finite upload latency for a "
                                   "scheduled UE")
            self._store[wave] = {"uploads": uploads, "weights": weights,
                                 "left": sel.size}
            self._busy[sel] = True
            for i, ue in enumerate(sel):
                e = _Upload(ue=int(ue), wave=wave, version=self.version,
                            row=i, latency=float(lat[i]),
                            acc_local=float(acc_local[i]),
                            acc_test=float(acc_test[i]),
                            acc_val=(None if acc_val is None
                                     else np.asarray(acc_val[:, i])))
                heapq.heappush(self._heap,
                               (self.t_sim + e.latency, self._seq, e))
                self._seq += 1
            if trace.enabled():
                trace.gauge_set("async.heap_depth", len(self._heap))

    # ------------------------------------------------------------------ #
    def _gather(self, entries: List[_Upload]):
        """(uploads, weights, ages, discounts) of the buffered entries in
        arrival order, the weights staleness-discounted. At zero latency
        this is the identity gather of one wave's stack: the synchronous
        aggregation's inputs, bit for bit."""
        srv = self.server
        ages = np.array([self.version - e.version for e in entries])
        disc = ctl.staleness_discount(ages, srv.cfg.async_staleness)
        if srv.engine == "loop":
            uploads = [self._store[e.wave]["uploads"][e.row]
                       for e in entries]
            base = np.array([self._store[e.wave]["weights"][e.row]
                             for e in entries], float)
            return uploads, base * disc, ages, disc
        # vectorized: each wave's real rows gathered on the device, merged
        # back into arrival order, padded to the stable row multiple
        n = len(entries)
        parts, w_parts, pos_parts = [], [], []
        for w in dict.fromkeys(e.wave for e in entries):
            pos = np.array([i for i, e in enumerate(entries)
                            if e.wave == w])
            rows = np.array([entries[i].row for i in pos])
            st = self._store[w]
            idx = torch.as_tensor(rows, device=srv.device)
            parts.append({k: v.index_select(0, idx)
                          for k, v in st["uploads"].items()})
            w_parts.append(np.asarray(st["weights"])[rows])
            pos_parts.append(pos)
        inv = np.argsort(np.concatenate(pos_parts), kind="stable")
        stacked = cohort.merge_stacks(parts, inv if len(parts) > 1 else None)
        n_pad = cohort.pad_count(n, FeelServer._N_BUCKET)
        stacked_p = cohort.pad_stacked(stacked, n_pad)
        weights = np.zeros(n_pad)
        weights[:n] = np.concatenate(w_parts)[inv] * disc
        return stacked_p, weights, ages, disc

    def _aggregate(self, trigger: str) -> RoundLog:
        """Flush the buffer into the global model (staleness-discounted
        FedAvg or the defense's robust aggregator), finalise Eq. 1 for the
        aggregated UEs, log the RoundLog and the AggregationLog."""
        srv = self.server
        with trace.span("async.aggregate") as sp:
            entries, self._buffer = self._buffer, []
            sel = np.array([e.ue for e in entries])
            uploads, weights, ages, disc = self._gather(entries)
            if trace.enabled():
                sp.set(version=self.version, trigger=trigger,
                       n_uploads=len(entries), mean_age=float(ages.mean()))
                for a in ages:
                    trace.observe("async.upload_age", float(a))
                trace.gauge_set("async.heap_depth", len(self._heap))
            srv._aggregate_uploads(sel, uploads, weights)
            for e in entries:
                st = self._store[e.wave]
                st["left"] -= 1
                if st["left"] == 0:
                    del self._store[e.wave]
            self._busy[sel] = False
            acc_local = np.array([e.acc_local for e in entries])
            acc_test = np.array([e.acc_test for e in entries])
            acc_val = (None if entries[0].acc_val is None
                       else np.stack([e.acc_val for e in entries], axis=1))
            g_acc, g_loss, src_acc, atk_succ = srv._global_metrics()
            values, sched, forced = self._plan
            log = srv._finalize_round(self.version, values, sched, sel,
                                      forced, acc_local, acc_test, g_acc,
                                      src_acc, atk_succ, acc_val, g_loss)
            self.agg_logs.append(AggregationLog(
                version=self.version, sim_time=self.t_sim, trigger=trigger,
                n_uploads=len(entries), ages=ages, discounts=disc,
                waves=np.array([e.wave for e in entries])))
            self.version += 1
            return log

    # ------------------------------------------------------------------ #
    def _trigger(self) -> bool:
        """Buffer-fill trigger: B uploads buffered, or, with
        ``async_buffer=None``, every upload in flight arrived."""
        if self.server.cfg.async_buffer is not None:
            return len(self._buffer) >= self.server.cfg.async_buffer
        return not self._heap

    def run(self, rounds: Optional[int] = None) -> List[RoundLog]:
        """Run ``rounds`` aggregations (default cfg.rounds) and return the
        server's RoundLogs, one an aggregation."""
        n_agg = rounds or self.server.cfg.rounds
        # while the event loop drives, every span records the simulated
        # clock beside the wall clock; reading ``t_sim`` is telemetry only
        trace.set_sim_clock(lambda: self.t_sim)
        try:
            self._run(n_agg)
        finally:
            trace.set_sim_clock(None)
        return self.server.logs

    def _run(self, n_agg: int) -> None:
        cfg = self.server.cfg
        self._dispatch()
        while self.version < n_agg:
            deadline = (math.inf if cfg.async_deadline is None
                        else self._dispatch_t + cfg.async_deadline)
            if self._heap and (not self._buffer
                               or self._heap[0][0] <= deadline):
                t_arr, _, e = heapq.heappop(self._heap)
                self.t_sim = max(self.t_sim, t_arr)
                self._buffer.append(e)
                if not self._trigger():
                    continue
                trig = "buffer" if cfg.async_buffer is not None else "wave"
            elif self._buffer:
                # the next arrival, if any, is past the deadline: flush
                # what has landed; with no deadline this is the drain
                if math.isfinite(deadline):
                    self.t_sim = max(self.t_sim, deadline)
                    trig = "deadline"
                else:
                    trig = "drain"
            else:
                # an empty heap and buffer means no UE is busy, so the
                # dispatch before scheduled at least one upload (the forced
                # rewrite guarantees a non-empty selection of idle UEs)
                raise RuntimeError("async engine stalled: empty event heap "
                                   "and empty buffer")
            self._aggregate(trig)
            self._dispatch()
