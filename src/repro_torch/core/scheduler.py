"""Joint UE selection + bandwidth allocation (paper §IV, Algorithm 2).

Problem (8) — maximise ``sum_k x_k V_k`` subject to the round deadline (8b),
total bandwidth (8c/8d) and binary selection (8e) — is knapsack-equivalent
(NP-hard). DQS solves it greedily: compute each UE's bandwidth *cost* ``c_k``
(minimum number of uniform 1/K fractions meeting its minimum rate, Eq. 9),
order by ``V_k / c_k`` decreasing, and pack into the budget of K fractions,
then take the better of the greedy pack and the single best feasible UE
(the modified greedy, ``objective >= OPT / 2``).

Every packing policy is one *priority key* feeding one shared greedy-packing
primitive: sort ascending by the key, then walk the order consuming the
budget of K fractions, SKIPPING any UE whose cost does not fit (a later,
cheaper UE may still fit). ``priority_key`` builds the key per policy:

    dqs          -(V_k / c_k)          (Alg. 2 density order)
    random       inverse permutation    (uniform order, Li et al. style)
    best_channel c_k*K - gains/max      (Nishio & Yonetani: good channels)
    max_count    c_k                    (Zeng et al.: cheapest first)

``top_value`` (paper §V-B.1) is the one non-packing policy: top-N by value,
no wireless constraint. ``brute_force_schedule`` is the exact solver for
small K (test oracle).

A numpy copy of the host half of ``repro.core.scheduler``: the same inputs
and RNG give the same schedules exactly. ``pack_scan`` and
``greedy_pack_rows`` are the batched control plane's tensor twins of
``greedy_pack`` (core/control.py), over (R, N) rows on any device;
``order_key`` makes a tensor sort order keys as numpy's does.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from repro_torch.configs.base import FeelConfig

POLICY_NAMES = ("dqs", "random", "best_channel", "max_count", "top_value")
# Integer ids the batched control plane (core/control.py) selects a run's
# priority key by.
POLICY_IDS = {name: i for i, name in enumerate(POLICY_NAMES)}


@dataclasses.dataclass
class Schedule:
    x: np.ndarray          # (K,) bool selection
    alpha: np.ndarray      # (K,) bandwidth fractions, sum <= 1
    cost: np.ndarray       # (K,) c_k in fractions (K+1 = infeasible)
    value: np.ndarray      # (K,) V_k used for the decision

    @property
    def selected(self) -> np.ndarray:
        return np.flatnonzero(self.x)

    def objective(self) -> float:
        return float(self.value[self.x].sum())


def greedy_pack(order: np.ndarray, costs: np.ndarray, k: int):
    """Walk ``order`` packing UEs into a budget of ``k`` fractions.

    A UE whose cost exceeds the *remaining* budget (or the deadline, c > K)
    is skipped and the walk continues. Returns (x bool (N,), alpha (N,)).
    """
    x = np.zeros(len(costs), bool)
    alpha = np.zeros(len(costs))
    budget = k
    for u in order:
        c = int(costs[u])
        if c <= k and budget - c >= 0:
            x[u] = True
            alpha[u] = c / k
            budget -= c
    return x, alpha


def pack_scan(c_sorted: torch.Tensor, k: int) -> torch.Tensor:
    """Take-mask of the skipping greedy over PRE-SORTED costs (..., N).

    Not a masked prefix sum: ``greedy_pack`` SKIPS a UE that does not fit
    the remaining budget and walks on, so whether position i is packed
    depends on every earlier decision. But the budget changes only at a
    take, so the next take is the first later position whose cost is at
    most min(k, remaining budget). The walk jumps from take to take, every
    row at once: one masked first-true over all N positions a step, until
    no row finds one. Eq. 9's costs are at least 1, so a row takes at most
    k UEs and the walk ends within k + 1 steps whatever N is. The mask is
    the N-step walk's bit for bit, for any non-negative costs.
    """
    lead, n = c_sorted.shape[:-1], c_sorted.shape[-1]
    c = c_sorted.reshape(-1, n)
    rows, dev = c.shape[0], c.device
    # position n stands for "no take": it costs 0 and is dropped at the end
    c_or_0 = torch.cat([c, c.new_zeros((rows, 1))], -1)
    pos = torch.arange(n, device=dev)
    last = torch.full((rows, 1), -1, dtype=pos.dtype, device=dev)
    # the budget starts at k and only falls, so c <= budget implies c <= k
    budget = torch.full((rows, 1), k, dtype=c.dtype, device=dev)
    taken = []
    while True:
        nxt = torch.where((c <= budget) & (pos > last), pos,
                          n).amin(-1, keepdim=True)
        if int(nxt.amin()) >= n:        # no row takes again
            break
        taken.append(nxt)
        budget = budget - c_or_0.gather(-1, nxt)
        last = nxt
    take = torch.zeros((rows, n + 1), dtype=torch.bool, device=dev)
    if taken:
        take.scatter_(-1, torch.cat(taken, -1), True)
    return take[:, :n].reshape(*lead, n)


def order_key(key: torch.Tensor) -> torch.Tensor:
    """An int64 tensor whose stable ascending argsort is numpy's stable
    ascending argsort of the float64 ``key`` (``np.argsort(kind=
    "stable")``, ``jnp.argsort(stable=True)``): the order of (is NaN,
    key, index). -0.0 ties with +0.0, and every NaN follows +inf whatever
    its sign or payload: the key's bits, with -0.0 folded into +0.0 and
    the negative half's magnitude bits flipped, are an integer that grows
    with the float, and a NaN is the largest int64. An integer sort knows
    no NaN, where the card's float sort orders one by its sign bit."""
    bits = (key + 0.0).view(torch.int64)
    bits = torch.where(bits < 0, bits ^ 0x7FFF_FFFF_FFFF_FFFF, bits)
    return torch.where(key.isnan(), torch.iinfo(torch.int64).max, bits)


def greedy_pack_rows(sort_key: torch.Tensor, costs: torch.Tensor, k: int):
    """``greedy_pack`` for every row of (R, N) tensors at once: the stable
    ascending argsort of the float64 priority key (``order_key``: NaN keys
    last, in index order, as numpy sorts them), then the ``pack_scan``
    budget walk. ``k`` is only the budget; the width is N. ``costs`` int32;
    returns (x bool (R, N), alpha float64 (R, N))."""
    order = torch.argsort(order_key(sort_key), dim=-1, stable=True)
    take = pack_scan(torch.gather(costs, -1, order), k)
    x = torch.zeros_like(take).scatter(-1, order, take)
    alpha = torch.where(x, costs.to(torch.float64)
                        / torch.full_like(sort_key, float(k)), 0.0)
    return x, alpha


def priority_key(policy: str, values, costs, k: int,
                 gains=None, rand_rank=None):
    """Ascending-sort key whose stable argsort reproduces each packing
    policy's visit order (see module docstring). ``rand_rank`` is the
    inverse permutation of the ``random`` policy's visit order."""
    if policy == "dqs":
        return -(values / costs)
    if policy == "random":
        return rand_rank
    if policy == "best_channel":
        return costs * k - gains / (gains.max(-1, keepdims=True) + 1e-12)
    if policy == "max_count":
        return costs
    raise KeyError(policy)


def dqs_schedule(values: np.ndarray, costs: np.ndarray,
                 cfg: FeelConfig) -> Schedule:
    """Algorithm 2: greedy knapsack by V_k / c_k over a budget of K fractions,
    then the modified-greedy fallback: if the single best feasible UE beats
    the whole greedy pack, schedule it alone."""
    K = cfg.n_ues
    order = np.argsort(priority_key("dqs", values, costs, K), kind="stable")
    x, alpha = greedy_pack(order, costs, K)
    feas = costs <= K
    if feas.any():
        k_best = int(np.flatnonzero(feas)[np.argmax(values[feas])])
        if values[k_best] > values[x].sum():
            x = np.zeros(len(values), bool)
            x[k_best] = True
            alpha = np.zeros(len(values))
            alpha[k_best] = costs[k_best] / K
    return Schedule(x=x, alpha=alpha, cost=costs, value=values)


def brute_force_schedule(values: np.ndarray, costs: np.ndarray,
                         cfg: FeelConfig, max_k: int = 16) -> Schedule:
    """Exact knapsack by enumeration — oracle for tests (N <= max_k). The
    fraction budget is ``cfg.n_ues``; the candidate width is
    ``len(values)``."""
    K = cfg.n_ues
    N = len(values)
    if N < K or N > max_k:
        raise ValueError(f"brute force needs n_ues <= N <= {max_k}, "
                         f"got N={N}, K={K}")
    best, best_x = -1.0, np.zeros(N, bool)
    feas = [k for k in range(N) if costs[k] <= K]
    for r in range(len(feas) + 1):
        for combo in itertools.combinations(feas, r):
            c = sum(int(costs[k]) for k in combo)
            if c <= K:
                v = float(values[list(combo)].sum()) if combo else 0.0
                if v > best:
                    best = v
                    best_x = np.zeros(N, bool)
                    best_x[list(combo)] = True
    alpha = np.where(best_x, costs / K, 0.0)
    return Schedule(x=best_x, alpha=alpha, cost=costs, value=values)


# ---------------------------------------------------------------------- #
# Baseline policies (paper §II / §V comparisons)
# ---------------------------------------------------------------------- #
def random_schedule(values, costs, cfg, rng) -> Schedule:
    """Random feasible packing (ignores data quality)."""
    K = cfg.n_ues
    x, alpha = greedy_pack(rng.permutation(len(values)), costs, K)
    return Schedule(x=x, alpha=alpha, cost=costs, value=values)


def best_channel_schedule(values, costs, cfg, gains) -> Schedule:
    """Nishio & Yonetani-style: prioritise good channels (min cost first)."""
    K = cfg.n_ues
    order = np.argsort(priority_key("best_channel", values, costs, K,
                                    gains=gains), kind="stable")
    x, alpha = greedy_pack(order, costs, K)
    return Schedule(x=x, alpha=alpha, cost=costs, value=values)


def max_count_schedule(values, costs, cfg) -> Schedule:
    """Zeng et al.-style: maximise the number of scheduled UEs."""
    K = cfg.n_ues
    order = np.argsort(priority_key("max_count", values, costs, K),
                       kind="stable")
    x, alpha = greedy_pack(order, costs, K)
    return Schedule(x=x, alpha=alpha, cost=costs, value=values)


def top_value_schedule(values, costs, cfg, n: int) -> Schedule:
    """Paper §V-B.1: pick the n highest-V_k UEs (no wireless constraint).
    Selection ignores the channel, but ``Schedule.cost`` reports the real
    Eq. 9 costs."""
    order = np.argsort(-values, kind="stable")[:n]
    x = np.zeros(len(values), bool)
    x[order] = True
    alpha = np.where(x, 1.0 / max(n, 1), 0.0)
    return Schedule(x=x, alpha=alpha, cost=np.asarray(costs), value=values)


# name -> host oracle of the four packing policies (top_value, which
# takes the n highest values, has another signature)
POLICIES = {
    "dqs": dqs_schedule,
    "random": random_schedule,
    "best_channel": best_channel_schedule,
    "max_count": max_count_schedule,
}
