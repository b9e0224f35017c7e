"""Population plane: the state of N candidate devices and the
schedule-preserving top-M prefilter (paper §III-IV at population width).

A production FEEL server schedules each round's cohort from a population of
N candidates (up to 10^6), not from the K-sized plane of the paper's §V
protocol. ``PopulationState`` keeps that population as a struct-of-arrays,
one row a run, and feeds the batched control plane
(``core.control.schedule_runs`` / ``finalize_runs``) two ways:

  exact      — ``PopulationState.control_view`` scheduled by
      ``control.schedule_runs`` over all N candidates: a stable sort and
      the budget walk. The oracle.
  prefilter  — ``prefilter_schedule_runs``: the priority key of every
      packing policy is computed over all N candidates, but only the first
      M positions of the visit order (the stable ascending argsort prefix:
      ties to the lower index) enter the budget walk. The walk takes at
      most K UEs (every cost is at least 1), so M = 8K almost always holds
      the exact selection, and every round carries a certificate:

          B_rem < min{ c_u : u not kept }

      where B_rem is the budget left after packing the kept prefix. Every
      dropped candidate follows the kept prefix in visit order and the
      budget only falls, so the certificate means the N-wide walk takes no
      dropped candidate and the two selections are identical (an
      infeasible candidate costs K + 1 > B_rem). A row whose certificate
      fails is escalated to the exact path. The dqs fallback and the
      forced-round rewrite compare against reductions over all N, and a
      ``top_value`` row takes the first ``min_selected`` of its prefix in
      the order of -value, so neither needs the certificate.

Two layouts compute the prefilter, as in ``core/control.py``:

    "hybrid" — the CPU's: the elementwise math as batched numpy, the prefix
        by ``_topm_prefix`` (argpartition and a fixup of the pivot's
        ties), the Eq. 9 bisection and the walk on CPU tensors; stage for
        stage the control plane's hybrid layout, so a row whose certificate
        holds is bit-equal to it.
    "device" — the card's: every stage as float64 torch ops on the state's
        device. The prefix comes from ``torch.topk``'s M-th key and an
        index-ordered fixup of the ties at it (``_topm_prefix_rows``), never
        from the order ``topk`` returns ties in, which CUDA leaves
        undefined. Integer outputs (selection, costs, forced) equal the
        exact path's; the floats agree within a few ulp.

``scatter_finalize`` closes the loop: each round's K-sized results update
the N-wide state sparsely (``reputations[i, sel]`` and ``last_sel``, the
round of each candidate's last selection, whose difference to t is the
dense ages in exact integers), bit for bit against the dense
``finalize_runs``.

The population lives on one device: ``population_mesh`` is that device,
``shard_population`` moves arrays to it and ``bytes_per_device`` counts the
state's bytes on one of ``n_devices`` devices.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FeelConfig
from repro_torch.core import control as ctl
from repro_torch.core.diversity import (diversity_index_eq2,
                                        diversity_index_rows)
from repro_torch.core.quality import data_quality_value
from repro_torch.core.scheduler import POLICY_IDS, pack_scan, priority_key
from repro_torch.core.wireless import cost_bisect
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import trace

# Default M = PREFILTER_HEADROOM * K candidates survive the top-M cut. The
# walk takes at most K UEs, so K of headroom covers the selection and the
# rest buys certificate slack: the walk usually spends the whole budget on
# the cost-1 candidates near the top of the order, and B_rem = 0 passes.
PREFILTER_HEADROOM = 8


def default_m(cfg: FeelConfig) -> int:
    return min(cfg.n_population, PREFILTER_HEADROOM * cfg.n_ues)


@dataclasses.dataclass
class PopulationState:
    """Struct-of-arrays population state: R runs x N candidates (host
    numpy, float64).

    The mutable fields are ``reputations`` and ``last_sel`` (the round of
    a candidate's last selection, -1 for never): the dense ages the control
    plane reads are ``t - last_sel`` (1 at the start, +1 a round, 1 again
    after a selection), with no O(N) sweep a round. The rest is
    round-invariant and shared with the ``ControlState`` view. ``device``
    is where the "device" layout computes.
    """
    policy_id: np.ndarray     # (R,)  int32, scheduler.POLICY_IDS
    sizes: np.ndarray         # (R, N) float64 true dataset sizes
    divs: np.ndarray          # (R, N) element (Gini-Simpson) diversities
    r_min: np.ndarray         # (R, N) Eq. 9 min rates (round-invariant)
    reputations: np.ndarray   # (R, N) Eq. 1 state
    last_sel: np.ndarray      # (R, N) int64 round of last selection, -1
    cfg: FeelConfig
    device: torch.device = torch.device("cpu")

    @property
    def n_runs(self) -> int:
        return self.policy_id.shape[0]

    @property
    def n_population(self) -> int:
        return self.reputations.shape[1]

    def ages(self, t: int) -> np.ndarray:
        """Dense staleness ages at schedule time of round ``t``."""
        return (t - self.last_sel).astype(float)

    def nbytes(self) -> int:
        return (self.sizes.nbytes + self.divs.nbytes + self.r_min.nbytes
                + self.reputations.nbytes + self.last_sel.nbytes)

    @classmethod
    def from_control(cls, state: ctl.ControlState,
                     t: int = 0) -> "PopulationState":
        """Adopt a dense control state at round ``t`` (ages -> last_sel)."""
        return cls(policy_id=np.asarray(state.policy_id),
                   sizes=np.asarray(state.sizes, float),
                   divs=np.asarray(state.divs, float),
                   r_min=np.asarray(state.r_min, float),
                   reputations=np.array(state.reputations, float),
                   last_sel=(t - np.asarray(state.ages)).astype(np.int64),
                   cfg=state.cfg, device=state.device)

    def control_view(self, t: int) -> ctl.ControlState:
        """A ``ControlState`` over the SAME buffers, ages materialised for
        round ``t``: schedule it with ``schedule_runs`` or
        ``prefilter_schedule_runs``, and finalise through
        ``scatter_finalize``, not ``finalize_runs``."""
        return ctl.ControlState(
            policy_id=self.policy_id, sizes=self.sizes, divs=self.divs,
            r_min=self.r_min, reputations=self.reputations,
            ages=self.ages(t), cfg=self.cfg, device=self.device)


def scatter_finalize(pop: PopulationState, t: int,
                     sels: List[np.ndarray],
                     acc_locals: List[np.ndarray],
                     acc_tests: List[np.ndarray],
                     penalties: Optional[List] = None) -> None:
    """Eq. 1 and staleness from K-sized round results, scattered into the
    N-wide state: O(R·K) writes, no O(N) sweep.

    Bit for bit against the dense ``finalize_runs`` hybrid layout: the
    cohort average is ``np.mean`` over the compressed cohort and the
    delta and clip are the same float64 operations in the same order; the
    ages agree because ``t - last_sel`` is integer arithmetic.
    """
    cfg = pop.cfg
    for i, (sel, a, te) in enumerate(zip(sels, acc_locals, acc_tests)):
        sel = np.asarray(sel, int)
        if sel.size == 0:
            continue
        a = np.asarray(a, float)
        te = np.asarray(te, float)
        delta = cfg.eta * (cfg.beta1 * (a - np.mean(a))
                           + cfg.beta2 * (a - te))
        if penalties is not None and penalties[i] is not None:
            delta = delta + penalties[i]
        pop.reputations[i, sel] = np.clip(
            pop.reputations[i, sel] - delta, 0.0, 1.0)
        pop.last_sel[i, sel] = t


# ---------------------------------------------------------------------- #
# The visit-order prefix
# ---------------------------------------------------------------------- #
def _topm_prefix(keys: np.ndarray, m: int) -> np.ndarray:
    """First ``m`` positions of each row's visit order — the stable
    ascending argsort prefix (ties to the lower index) — in O(N + m log m)
    a row: argpartition, then the keys below the pivot and the first of
    its ties in index order, then a stable sort of those m."""
    R, _ = keys.shape
    out = np.empty((R, m), np.int64)
    for i in range(R):
        k = keys[i]
        part = np.argpartition(k, m - 1)[:m]
        pivot = k[part].max()
        strict = np.flatnonzero(k < pivot)
        ties = np.flatnonzero(k == pivot)[:m - strict.size]
        idx = np.concatenate([strict, ties])
        # equal keys keep their ascending-index layout
        out[i] = idx[np.argsort(k[idx], kind="stable")]
    return out


def _topm_prefix_rows(keys: torch.Tensor, m: int) -> torch.Tensor:
    """``_topm_prefix`` over an (R, N) float64 tensor on any device.

    Only the VALUES of ``torch.topk`` are read — its M-th smallest key, the
    pivot — never the order it returns ties in. Every key below the pivot
    is kept, then the pivot's ties in index order (a running count) up to
    M; ``nonzero`` lists the M kept positions of each row in index order,
    and a stable sort by key puts them in visit order."""
    R = keys.shape[0]
    pivot = torch.topk(keys, m, dim=-1, largest=False,
                       sorted=False).values.amax(-1, keepdim=True)
    below = keys < pivot
    tie = keys == pivot
    room = m - below.sum(-1, keepdim=True)
    kept = below | (tie & (torch.cumsum(tie, -1) <= room))
    idx = kept.nonzero()[:, 1].reshape(R, m)
    order = torch.argsort(keys.gather(-1, idx), dim=-1, stable=True)
    return idx.gather(-1, order)


# ---------------------------------------------------------------------- #
# "hybrid" layout: batched numpy + the control plane's CPU tensor steps
# ---------------------------------------------------------------------- #
def _prefilter_hybrid(state: ctl.ControlState, gains, rand_rank, w_rep,
                      w_div, m: int):
    """The control plane's hybrid layout (``control._schedule_hybrid``)
    stage for stage, over the kept prefix, so that a row whose certificate
    holds is bit-equal to it."""
    cfg = state.cfg
    K = cfg.n_ues
    R, N = state.reputations.shape
    pid = state.policy_id

    I = diversity_index_rows(state.divs, state.sizes, state.ages,
                             np.asarray(cfg.gamma, float))
    values = data_quality_value(state.reputations, I, cfg,
                                omega=(w_rep[:, None], w_div[:, None]))
    costs = cost_bisect(torch.from_numpy(gains),
                        torch.from_numpy(state.r_min), K, cfg.bandwidth_hz,
                        cfg.p_watt, cfg.n0_watt_hz).numpy().astype(int)
    costs_f = costs.astype(float)

    keys = np.empty((R, N))
    msk = pid == POLICY_IDS["dqs"]
    keys[msk] = priority_key("dqs", values[msk], costs_f[msk], K)
    msk = pid == POLICY_IDS["random"]
    keys[msk] = rand_rank[msk]
    msk = pid == POLICY_IDS["best_channel"]
    keys[msk] = priority_key("best_channel", values[msk], costs_f[msk], K,
                             gains=gains[msk])
    msk = pid == POLICY_IDS["max_count"]
    keys[msk] = costs_f[msk]
    # top_value rows cut by value, so the prefix holds the top-n selection
    msk = pid == POLICY_IDS["top_value"]
    keys[msk] = -values[msk]

    kept = _topm_prefix(keys, m)                       # (R, m) visit order
    rows = np.arange(R)[:, None]
    c_kept = costs[rows, kept].astype(np.int32)
    take = pack_scan(torch.from_numpy(c_kept), K).numpy()
    x = np.zeros((R, N), bool)
    x[rows, kept] = take
    alpha = np.where(x, costs_f / K, 0.0)

    # the preservation certificate
    b_rem = K - np.where(take, c_kept, 0).sum(-1)
    dropped = np.ones((R, N), bool)
    dropped[rows, kept] = False
    dmin = np.where(dropped, costs, K + 2).min(-1)
    cert = (b_rem < dmin) | (pid == POLICY_IDS["top_value"])

    # dqs modified-greedy fallback over all N; the pack sums the
    # compressed selection, as the hybrid exact path does
    feas = costs <= K
    masked = np.where(feas, values, -np.inf)
    k_best = masked.argmax(-1)
    ridx = np.arange(R)
    is_dqs = pid == POLICY_IDS["dqs"]
    pack_val = np.array([values[i][x[i]].sum() if is_dqs[i] else 0.0
                         for i in range(R)])
    use_fb = is_dqs & feas.any(-1) & (masked[ridx, k_best] > pack_val)
    fb = np.flatnonzero(use_fb)
    x[fb] = False
    x[fb, k_best[fb]] = True
    alpha[fb] = 0.0
    alpha[fb, k_best[fb]] = costs_f[fb, k_best[fb]] / K

    # top_value: the first n of the (-value)-ordered prefix, the exact
    # stable argsort(-values)[:n] (m >= n)
    tv = np.flatnonzero(pid == POLICY_IDS["top_value"])
    if tv.size:
        n = cfg.min_selected
        xt = np.zeros((tv.size, N), bool)
        xt[np.arange(tv.size)[:, None], kept[tv, :n]] = True
        x[tv] = xt
        alpha[tv] = np.where(xt, 1.0 / max(n, 1), 0.0)

    # degenerate rounds: force the single highest-value UE
    forced = ~x.any(-1)
    fr = np.flatnonzero(forced)
    kf = values[fr].argmax(-1)
    x[fr] = False
    x[fr, kf] = True
    alpha[fr] = 0.0
    alpha[fr, kf] = 1.0
    return x, alpha, costs, values, forced, cert


# ---------------------------------------------------------------------- #
# "device" layout: every stage as float64 torch ops on the state's device
# ---------------------------------------------------------------------- #
def _prefilter_device(state: ctl.ControlState, gains, rand_rank, w_rep,
                      w_div, m: int):
    """The control plane's device layout (``control._schedule_device``)
    with the walk over the kept prefix; the reductions over all N (the
    fallback's, the forced rewrite's) are that layout's own, so the two
    agree exactly whenever the selections do."""
    cfg = state.cfg
    K = cfg.n_ues
    n_sel = cfg.min_selected
    dev = state.device

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    pid = torch.as_tensor(state.policy_id, device=dev)[:, None]
    g = f64(gains)
    I = diversity_index_eq2(f64(state.divs), f64(state.sizes),
                            f64(state.ages), cfg.gamma)
    values = data_quality_value(f64(state.reputations), I, None,
                                omega=(f64(w_rep)[:, None],
                                       f64(w_div)[:, None]))
    costs = cost_bisect(g, f64(state.r_min), K, cfg.bandwidth_hz,
                        cfg.p_watt, cfg.n0_watt_hz)
    costs_f = costs.to(torch.float64)
    k_f = torch.full_like(costs_f, float(K))
    key = torch.where(
        pid == POLICY_IDS["dqs"], -(values / costs_f),
        torch.where(
            pid == POLICY_IDS["random"], f64(rand_rank),
            torch.where(pid == POLICY_IDS["best_channel"],
                        costs_f * K - g / (g.amax(-1, keepdim=True) + 1e-12),
                        costs_f)))
    top = pid == POLICY_IDS["top_value"]
    key = torch.where(top, -values, key)
    if bool(key.isnan().any()):
        raise ValueError("NaN priority key: the control plane's inputs "
                         "hold a NaN")

    kept = _topm_prefix_rows(key, m)                   # (R, m) visit order
    c_kept = costs.gather(-1, kept)
    take = pack_scan(c_kept, K)
    x = torch.zeros_like(key, dtype=torch.bool).scatter(-1, kept, take)
    alpha = torch.where(x, costs_f / k_f, 0.0)

    # the preservation certificate
    b_rem = K - torch.where(take, c_kept, 0).sum(-1)
    dmin = costs.scatter(-1, kept, K + 2).amin(-1)
    cert = (b_rem < dmin) | top[:, 0]

    # dqs modified-greedy fallback over all N
    feas = costs <= K
    masked = torch.where(feas, values, -torch.inf)
    k_best = masked.argmax(-1, keepdim=True)
    use_fb = ((pid == POLICY_IDS["dqs"]) & feas.any(-1, keepdim=True)
              & (masked.gather(-1, k_best)
                 > (values * x).sum(-1, keepdim=True)))
    onehot_best = torch.zeros_like(x).scatter(-1, k_best, True)
    x = torch.where(use_fb, onehot_best, x)
    alpha = torch.where(use_fb, torch.where(onehot_best, costs_f / k_f, 0.0),
                        alpha)

    # top_value: the first n_sel of the (-value)-ordered prefix
    xt = torch.zeros_like(x).scatter(-1, kept[:, :n_sel], True)
    x = torch.where(top, xt, x)
    alpha = torch.where(top, torch.where(
        xt, torch.full_like(alpha, 1.0 / max(n_sel, 1)), 0.0), alpha)

    # degenerate rounds: force the single highest-value UE
    forced = ~x.any(-1, keepdim=True)
    onehot_f = torch.zeros_like(x).scatter(
        -1, values.argmax(-1, keepdim=True), True)
    x = torch.where(forced, onehot_f, x)
    alpha = torch.where(forced, onehot_f.to(torch.float64), alpha)
    return (x.cpu().numpy(), alpha.cpu().numpy(),
            costs.cpu().numpy().astype(int), values.cpu().numpy(),
            forced[:, 0].cpu().numpy(), cert.cpu().numpy())


# ---------------------------------------------------------------------- #
# Entry point
# ---------------------------------------------------------------------- #
def _state_nbytes(state: ctl.ControlState) -> int:
    """Resident bytes of the (R, N) control-plane state, the accounting of
    ``PopulationState.nbytes`` (the ``population.nbytes`` gauge only)."""
    return sum(np.asarray(a).nbytes
               for a in (state.sizes, state.divs, state.r_min,
                         state.reputations, state.ages))


def prefilter_schedule_runs(state: ctl.ControlState, gains, rand_rank,
                            w_rep, w_div, m: Optional[int] = None,
                            kernel: Optional[str] = None):
    """Schedule round t of all R runs through the top-M prefilter.

    The inputs and outputs of ``control.schedule_runs`` plus an ``info``
    dict: ``(x, alpha, costs, values, forced, info)`` with
    ``info = {"m", "n_escalated"}``. Every run's schedule is the exact
    path's: a row whose certificate holds by the preservation argument (the
    module docstring), a row whose certificate fails by escalation to
    ``schedule_runs`` itself. ``m`` defaults to ``default_m``; ``kernel``
    is "hybrid" | "device" (None: the state's device decides).
    """
    cfg = state.cfg
    gains = np.asarray(gains, float)
    rand_rank = np.asarray(rand_rank)
    w_rep = np.asarray(w_rep, float)
    w_div = np.asarray(w_div, float)
    N = state.reputations.shape[1]
    m_eff = int(min(m if m is not None else default_m(cfg), N))
    if m_eff < cfg.min_selected:
        raise ValueError(f"prefilter width {m_eff} below min_selected="
                         f"{cfg.min_selected}")
    kern = ctl._layout(kernel, state.device)
    R = state.n_runs
    with trace.span("schedule.prefilter") as sp:
        if m_eff >= N:      # no cut: the exact path is the prefilter
            out = ctl.schedule_runs(state, gains, rand_rank, w_rep, w_div,
                                    kernel=kern)
            if trace.enabled():
                sp.set(m=N, runs=int(R), width=int(N), n_escalated=0)
                trace.gauge_set("population.nbytes",
                                float(_state_nbytes(state)))
            return (*out, {"m": N, "n_escalated": 0})

        layout = _prefilter_hybrid if kern == "hybrid" else _prefilter_device
        x, alpha, costs, values, forced, cert = layout(
            state, gains, rand_rank, w_rep, w_div, m_eff)

        # escalate the rows whose certificate fails to the exact path, in
        # one batched call over just those rows
        bad = np.flatnonzero(~cert)
        if bad.size:
            sub = ctl.ControlState(
                policy_id=state.policy_id[bad], sizes=state.sizes[bad],
                divs=state.divs[bad], r_min=state.r_min[bad],
                reputations=state.reputations[bad], ages=state.ages[bad],
                cfg=cfg, device=state.device)
            xs, als, cs, vs, fs = ctl.schedule_runs(
                sub, gains[bad], rand_rank[bad], w_rep[bad], w_div[bad],
                kernel=kern)
            x[bad], alpha[bad], forced[bad] = xs, als, fs
            costs[bad], values[bad] = cs, vs
        if trace.enabled():
            sp.set(m=m_eff, runs=int(R), width=int(N),
                   n_escalated=int(bad.size))
            trace.counter_inc("population.escalations", int(bad.size))
            trace.gauge_set("population.nbytes",
                            float(_state_nbytes(state)))
        return (x, alpha, costs, values, forced,
                {"m": m_eff, "n_escalated": int(bad.size)})


# ---------------------------------------------------------------------- #
# One device
# ---------------------------------------------------------------------- #
def population_mesh(device: DeviceLike = None) -> torch.device:
    """The device the population axis lives on (None: the GPU, which
    raises without CUDA). The port runs a population on one device."""
    return resolve_device(device)


def shard_population(mesh: torch.device, *arrays):
    """Place (R, N) control arrays on ``mesh``'s device, dtypes kept."""
    out = tuple(torch.as_tensor(np.asarray(a), device=mesh) for a in arrays)
    return out if len(out) != 1 else out[0]


def bytes_per_device(pop: PopulationState, n_devices: int = 1) -> int:
    """Resident population-state bytes a device when the N axis is split
    over ``n_devices`` (the policy ids are on every device)."""
    return pop.nbytes() // max(n_devices, 1) + pop.policy_id.nbytes
