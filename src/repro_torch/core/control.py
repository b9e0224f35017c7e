"""Batched control plane (paper §III-IV, all runs at once).

The paper's per-round control loop — channel draw -> Eq. 9 bandwidth costs
-> Eq. 2/3 data-quality values -> Algorithm 2 selection -> Eq. 1 reputation
update — runs for R runs together: their control state lives in a
``ControlState`` struct-of-arrays with a leading run axis, and round t of
every run is scheduled in one pass.

    schedule_runs — values (Eq. 2/3) -> costs (Eq. 9 monotone bisection)
        -> per-policy priority key -> shared greedy packing -> dqs
        modified-greedy fallback / top-value override -> forced-round
        rewrite. No per-run Python.
    finalize_runs — Eq. 1 reputation update + staleness ages of every run
        in one call.

Two layouts compute the same schedule:

    "hybrid" — the CPU's: the elementwise math and the stable argsort as
        batched numpy (the host oracle's own float64 expressions and
        summation order, over the (R, K) block), and the two steps numpy
        cannot express — the Eq. 9 bisection and the budget-carrying pack
        walk — as float64 torch ops on CPU tensors. Bit for bit against the
        host oracle on every output.
    "device" — the card's: the whole phase as float64 torch ops on the
        state's device (the reference's "jax" layout). Every quotient is by
        a tensor (CUDA divides by a host scalar as a product with its
        reciprocal), but the card's log2 may differ from libm's by an ulp
        and its sums group otherwise than numpy's, so the integer outputs
        (selection, costs, forced) are exact and the floats agree within a
        few ulp. Its sorts take ``scheduler.order_key``, so a NaN value or
        priority key is ordered as numpy orders it (last, in index
        order), and the schedule is the hybrid layout's.

``default_kernel(device)`` picks "device" for a CUDA device and "hybrid"
for the CPU. Randomness stays on the host: each run draws its channel
gains (and, for the ``random`` policy, its permutation) from its own numpy
Generator — the sequential oracle's streams — and both layouts are
deterministic functions of those draws. The per-run numpy path stays as
``FeelServer(..., control="host")``, the parity oracle.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import FeelConfig
from repro_torch.core.diversity import (diversity_index_eq2,
                                        diversity_index_rows)
from repro_torch.core.quality import data_quality_value
from repro_torch.core.reputation import reputation_update_eq1
from repro_torch.core.scheduler import (POLICY_IDS, greedy_pack_rows,
                                        order_key, pack_scan, priority_key)
from repro_torch.core.wireless import cost_bisect
from repro_torch.obs import trace

LAYOUTS = ("hybrid", "device")


@dataclasses.dataclass
class ControlState:
    """Struct-of-arrays control state of R runs over K UEs each (host
    numpy, float64).

    The static per-run fields (sizes, element diversities, Eq. 9 minimum
    rates, policy ids) are stacked once; the mutable ones (reputations,
    ages) are synced from and to the owning ``FeelServer`` objects around
    each round (``pull`` / ``push``), so the servers' logs and summaries
    keep reading their own attributes. ``device`` is where the "device"
    layout computes.
    """
    policy_id: np.ndarray     # (R,)  int32, scheduler.POLICY_IDS
    sizes: np.ndarray         # (R, K) float64 true dataset sizes
    divs: np.ndarray          # (R, K) element (Gini-Simpson) diversities
    r_min: np.ndarray         # (R, K) Eq. 9 min rates (round-invariant)
    reputations: np.ndarray   # (R, K) Eq. 1 state
    ages: np.ndarray          # (R, K) rounds since last selected
    cfg: FeelConfig           # shared scalars (one config for every run)
    device: torch.device = torch.device("cpu")

    @property
    def n_runs(self) -> int:
        return self.policy_id.shape[0]

    @classmethod
    def from_servers(cls, servers: Sequence) -> "ControlState":
        cfg = servers[0].cfg
        # the control plane never touches the data or model plane, so
        # configs that differ only in ``task`` share one state
        if any(dataclasses.replace(s.cfg, task=cfg.task) != cfg
               for s in servers):
            raise ValueError("batched control needs one FeelConfig across "
                             "its runs (the task field aside)")
        return cls(
            policy_id=np.array([POLICY_IDS[s.policy] for s in servers],
                               np.int32),
            sizes=np.stack([s.sizes for s in servers]).astype(float),
            divs=np.stack([s.divs for s in servers]).astype(float),
            r_min=np.stack([
                s.wireless.min_rate(s.wireless.train_time(s.sizes, s.cpu_hz))
                for s in servers]),
            reputations=np.stack([s.reputation.values for s in servers]),
            ages=np.stack([s.ages for s in servers]),
            cfg=cfg, device=servers[0].device)

    def pull(self, servers: Sequence) -> None:
        """Refresh the mutable rows from the servers (before a round)."""
        for i, s in enumerate(servers):
            self.reputations[i] = s.reputation.values
            self.ages[i] = s.ages

    def push(self, servers: Sequence) -> None:
        """Write the mutable rows back to the servers (after finalize)."""
        for i, s in enumerate(servers):
            s.reputation.values[:] = self.reputations[i]
            s.ages[:] = self.ages[i]


def default_kernel(device) -> str:
    """"device" for a CUDA device, "hybrid" for the CPU (numpy's sort and
    elementwise math beat many small torch launches there)."""
    return "device" if torch.device(device).type == "cuda" else "hybrid"


def _layout(kernel: Optional[str], device) -> str:
    kern = kernel or default_kernel(device)
    if kern not in LAYOUTS:
        raise ValueError(f"unknown control layout {kern!r}")
    return kern


# ---------------------------------------------------------------------- #
# "hybrid" layout: batched numpy + the two steps numpy cannot express
# ---------------------------------------------------------------------- #
def _schedule_hybrid(state: ControlState, gains, rand_rank, w_rep, w_div):
    cfg = state.cfg
    K = cfg.n_ues                        # bandwidth budget (fractions)
    R, N = state.reputations.shape      # N: candidate width
    pid = state.policy_id

    # Eq. 2/3 — batched numpy, the host oracle's float64 ops
    I = diversity_index_rows(state.divs, state.sizes, state.ages,
                             np.asarray(cfg.gamma, float))
    values = data_quality_value(state.reputations, I, cfg,
                                omega=(w_rep[:, None], w_div[:, None]))

    # Eq. 9 — the bisection on CPU tensors
    costs = cost_bisect(torch.from_numpy(gains),
                        torch.from_numpy(state.r_min), K, cfg.bandwidth_hz,
                        cfg.p_watt, cfg.n0_watt_hz).numpy().astype(int)
    costs_f = costs.astype(float)

    # priority keys — the one definition in scheduler.priority_key
    keys = np.empty((R, N))
    m = pid == POLICY_IDS["dqs"]
    keys[m] = priority_key("dqs", values[m], costs_f[m], K)
    m = pid == POLICY_IDS["random"]
    keys[m] = rand_rank[m]
    m = pid == POLICY_IDS["best_channel"]
    keys[m] = priority_key("best_channel", values[m], costs_f[m], K,
                           gains=gains[m])
    m = (pid == POLICY_IDS["max_count"]) | (pid == POLICY_IDS["top_value"])
    keys[m] = costs_f[m]                 # top_value rows: key unused

    # shared greedy pack: numpy's stable sort, then the budget walk
    order = np.argsort(keys, axis=-1, kind="stable")
    c_sorted = np.take_along_axis(costs, order, -1).astype(np.int32)
    take = pack_scan(torch.from_numpy(c_sorted), K).numpy()
    x = np.zeros((R, N), bool)
    np.put_along_axis(x, order, take, -1)
    alpha = np.where(x, costs_f / K, 0.0)

    # dqs modified-greedy fallback. The pack value sums the COMPRESSED
    # selection exactly like the host oracle (values[x].sum()): a full-K
    # masked sum groups numpy's pairwise summation otherwise and could
    # flip the '>' on a one-ulp tie.
    feas = costs <= K
    masked = np.where(feas, values, -np.inf)
    k_best = masked.argmax(-1)
    rows = np.arange(R)
    is_dqs = pid == POLICY_IDS["dqs"]
    pack_val = np.array([values[i][x[i]].sum() if is_dqs[i] else 0.0
                         for i in range(R)])
    use_fb = is_dqs & feas.any(-1) & (masked[rows, k_best] > pack_val)
    fb = np.flatnonzero(use_fb)
    x[fb] = False
    x[fb, k_best[fb]] = True
    alpha[fb] = 0.0
    alpha[fb, k_best[fb]] = costs_f[fb, k_best[fb]] / K

    # top_value override: top-n by value, no wireless constraint
    tv = np.flatnonzero(pid == POLICY_IDS["top_value"])
    if tv.size:
        n = cfg.min_selected
        top = np.argsort(-values[tv], axis=-1, kind="stable")[:, :n]
        xt = np.zeros((tv.size, N), bool)
        np.put_along_axis(xt, top, True, -1)
        x[tv] = xt
        alpha[tv] = np.where(xt, 1.0 / max(n, 1), 0.0)

    # degenerate rounds: no UE met the deadline — force the single
    # highest-value UE (whole band); the caller logs objective 0.0
    forced = ~x.any(-1)
    fr = np.flatnonzero(forced)
    kf = values[fr].argmax(-1)
    x[fr] = False
    x[fr, kf] = True
    alpha[fr] = 0.0
    alpha[fr, kf] = 1.0
    return x, alpha, costs, values, forced


# ---------------------------------------------------------------------- #
# "device" layout: the whole phase as float64 torch ops on the device
# ---------------------------------------------------------------------- #
def _schedule_device(state: ControlState, gains, rand_rank, w_rep, w_div):
    cfg = state.cfg
    K = cfg.n_ues
    n_sel = cfg.min_selected
    dev = state.device

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    pid = torch.as_tensor(state.policy_id, device=dev)[:, None]
    g = f64(gains)
    # Eq. 2/3
    I = diversity_index_eq2(f64(state.divs), f64(state.sizes),
                            f64(state.ages), cfg.gamma)
    values = data_quality_value(f64(state.reputations), I, None,
                                omega=(f64(w_rep)[:, None],
                                       f64(w_div)[:, None]))
    # Eq. 9
    costs = cost_bisect(g, f64(state.r_min), K, cfg.bandwidth_hz,
                        cfg.p_watt, cfg.n0_watt_hz)
    costs_f = costs.to(torch.float64)
    k_f = torch.full_like(costs_f, float(K))
    # priority keys (scheduler.priority_key's, as tensors)
    key = torch.where(
        pid == POLICY_IDS["dqs"], -(values / costs_f),
        torch.where(
            pid == POLICY_IDS["random"], f64(rand_rank),
            torch.where(pid == POLICY_IDS["best_channel"],
                        costs_f * K - g / (g.amax(-1, keepdim=True) + 1e-12),
                        costs_f)))
    x, alpha = greedy_pack_rows(key, costs, K)

    # dqs modified-greedy fallback: the best single feasible UE against
    # the pack, whose value sums the selected values alone (the host
    # oracle's values[x].sum(): an unselected NaN value adds nothing)
    feas = costs <= K
    masked = torch.where(feas, values, -torch.inf)
    k_best = masked.argmax(-1, keepdim=True)
    use_fb = ((pid == POLICY_IDS["dqs"]) & feas.any(-1, keepdim=True)
              & (masked.gather(-1, k_best)
                 > torch.where(x, values, 0.0).sum(-1, keepdim=True)))
    onehot_best = torch.zeros_like(x).scatter(-1, k_best, True)
    x = torch.where(use_fb, onehot_best, x)
    alpha = torch.where(use_fb, torch.where(onehot_best, costs_f / k_f, 0.0),
                        alpha)

    # top_value override (numpy's stable order of -values: NaN last)
    rank = torch.argsort(torch.argsort(order_key(-values), dim=-1,
                                       stable=True), dim=-1, stable=True)
    top = pid == POLICY_IDS["top_value"]
    x = torch.where(top, rank < n_sel, x)
    alpha = torch.where(top, torch.where(
        rank < n_sel, torch.full_like(alpha, 1.0 / max(n_sel, 1)), 0.0),
        alpha)

    # degenerate rounds: force the single highest-value UE
    forced = ~x.any(-1, keepdim=True)
    onehot_f = torch.zeros_like(x).scatter(
        -1, values.argmax(-1, keepdim=True), True)
    x = torch.where(forced, onehot_f, x)
    alpha = torch.where(forced, onehot_f.to(torch.float64), alpha)
    return (x.cpu().numpy(), alpha.cpu().numpy(),
            costs.cpu().numpy().astype(int), values.cpu().numpy(),
            forced[:, 0].cpu().numpy())


# ---------------------------------------------------------------------- #
# Host entry points
# ---------------------------------------------------------------------- #
def schedule_runs(state: ControlState, gains: np.ndarray,
                  rand_rank: np.ndarray, w_rep: np.ndarray,
                  w_div: np.ndarray, kernel: Optional[str] = None):
    """Schedule round t of all R runs in one batched pass.

    gains — (R, K) per-run channel draws (host RNG, the oracle's streams);
    rand_rank — (R, K) inverse permutations for ``random``-policy rows
    (ignored elsewhere); w_rep / w_div — (R,) Eq. 3 weights (annealed per
    round under adaptive omega); kernel — "hybrid" | "device" (None: the
    state's device decides, ``default_kernel``). Returns numpy (x bool,
    alpha, costs int, values, forced).
    """
    gains = np.asarray(gains, float)
    rand_rank = np.asarray(rand_rank)
    w_rep = np.asarray(w_rep, float)
    w_div = np.asarray(w_div, float)
    kern = _layout(kernel, state.device)
    with trace.span("schedule.pack") as sp:
        if trace.enabled():
            sp.set(kernel=kern, runs=int(state.n_runs),
                   width=int(state.reputations.shape[1]))
        if kern == "hybrid":
            return _schedule_hybrid(state, gains, rand_rank, w_rep, w_div)
        return _schedule_device(state, gains, rand_rank, w_rep, w_div)


def finalize_runs(state: ControlState, sels: List[np.ndarray],
                  acc_locals: List[np.ndarray],
                  acc_tests: List[np.ndarray],
                  penalties: Optional[List] = None,
                  kernel: Optional[str] = None) -> None:
    """Eq. 1 reputation + staleness of all R runs in one call, written back
    into ``state`` (callers then ``push`` to the servers).

    ``penalties`` — optional per-run defense trust penalties (aligned with
    ``sels``; entries may be None): the validation detector's extra
    subtracted Eq. 1 term.

    The hybrid layout applies Eq. 1 as batched numpy with the cohort
    average computed exactly like the host tracker (np.mean over the
    compressed cohort), bit for bit against ``ReputationTracker.update``;
    the device layout through ``reputation_update_eq1`` on the state's
    device.
    """
    cfg = state.cfg
    R, K = state.reputations.shape
    with trace.span("schedule.finalize") as sp:
        if trace.enabled():
            sp.set(runs=int(R), width=int(K))
        mask = np.zeros((R, K))
        al = np.zeros((R, K))
        at = np.zeros((R, K))
        pen = np.zeros((R, K))
        for i, (sel, a, t) in enumerate(zip(sels, acc_locals, acc_tests)):
            mask[i, sel] = 1.0
            al[i, sel] = a
            at[i, sel] = t
            if penalties is not None and penalties[i] is not None:
                pen[i, sel] = penalties[i]
        if _layout(kernel, state.device) == "hybrid":
            avg = np.array([[np.mean(a) if len(a) else 0.0]
                            for a in acc_locals])
            delta = cfg.eta * (cfg.beta1 * (al - avg)
                               + cfg.beta2 * (al - at)) + pen
            new = np.clip(state.reputations - delta, 0.0, 1.0)
            state.reputations = np.where(mask > 0, new, state.reputations)
            state.ages = np.where(mask > 0, 1.0, state.ages + 1.0)
            return

        def f64(a):
            return torch.as_tensor(a, dtype=torch.float64,
                                   device=state.device)

        m = f64(mask)
        rep = reputation_update_eq1(f64(state.reputations), m, f64(al),
                                    f64(at), cfg.eta, cfg.beta1, cfg.beta2,
                                    penalty=f64(pen))
        ages = torch.where(m > 0, 1.0, f64(state.ages) + 1.0)
        state.reputations = rep.cpu().numpy()
        state.ages = ages.cpu().numpy()


def staleness_discount(ages: np.ndarray, decay: float) -> np.ndarray:
    """Staleness discount d(a) = decay**a of the async engine.

    ``ages`` — integer aggregation ages (the aggregation version minus the
    model version the update was computed on), all >= 0; ``decay`` in
    (0, 1]. Host float64. d(0) == 1.0 exactly (any IEEE base to the 0th
    power), so an age-0 upload's weight ``w * d(0)`` is bit-identical to
    the FedAvg weight.
    """
    ages = np.asarray(ages)
    if not 0.0 < decay <= 1.0:
        raise ValueError(f"async_staleness must be in (0, 1]: {decay}")
    if np.any(ages < 0):
        raise ValueError("negative staleness age")
    return np.asarray(decay, np.float64) ** ages.astype(np.float64)
