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

A mesh splits the population axis: ``population_mesh`` is the
("data", "model") host mesh over the process group, ``shard_population``
places (R, N) arrays on it as ``DTensor``s split over "data", and
``prefilter_schedule_runs(..., mesh=)`` runs the "device" layout on each
rank's columns with explicit collectives (``_prefilter_device``), bit-equal
to one device; ``bytes_per_device`` counts a rank's share of the state.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import FeelConfig
from repro_torch.core import control as ctl
from repro_torch.core.diversity import (diversity_index_eq2,
                                        diversity_index_rows)
from repro_torch.core.quality import data_quality_value
from repro_torch.core.scheduler import (POLICY_IDS, order_key, pack_scan,
                                        priority_key)
from repro_torch.core.wireless import cost_bisect
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.obs import trace
from repro_torch.sharding.specs import (MeshShape, data_axes, mesh_shape,
                                        named)

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
        if np.isnan(pivot):     # numpy sorts NaN last: the prefix reaches
            strict = np.flatnonzero(~np.isnan(k))    # the NaN keys
            ties = np.flatnonzero(np.isnan(k))[:m - strict.size]
        else:
            strict = np.flatnonzero(k < pivot)
            ties = np.flatnonzero(k == pivot)[:m - strict.size]
        idx = np.concatenate([strict, ties])
        # equal keys keep their ascending-index layout
        out[i] = idx[np.argsort(k[idx], kind="stable")]
    return out


def _topm_prefix_rows(keys: torch.Tensor, m: int) -> torch.Tensor:
    """``_topm_prefix`` over an (R, N) float64 tensor on any device.

    The keys are compared as ``scheduler.order_key``'s integers, so NaN
    keys come last in index order and -0.0 ties with +0.0, as in numpy.
    Only the VALUES of ``torch.topk`` are read — its M-th smallest key, the
    pivot — never the order it returns ties in. Every key below the pivot
    is kept, then the pivot's ties in index order (a running count) up to
    M; ``nonzero`` lists the M kept positions of each row in index order,
    and a stable sort by key puts them in visit order."""
    R = keys.shape[0]
    keys = order_key(keys)
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
# "device" layout: every stage as float64 torch ops on the state's device,
# on one device or on each rank's columns of a mesh
# ---------------------------------------------------------------------- #
class _Shard:
    """This rank's columns of the population: the N axis split over the
    mesh's data axes in mesh order, each axis as ``torch.chunk`` splits
    (the blocks of ceil(n / size) first, then what is left, an empty one
    where nothing is), which is DTensor's ``Shard`` layout, uneven N
    included. ``groups`` are the data axes' process groups, the innermost
    first; no mesh (one device) and a ``MeshShape`` of one rank have none
    and run no collective."""

    def __init__(self, mesh, n: int):
        if mesh is None:
            mesh = MeshShape(("data",), (1,))
        shape = mesh_shape(mesh)
        axes = data_axes(mesh)
        self.sizes = [shape.shape[a] for a in axes]
        if isinstance(mesh, MeshShape):
            if shape.size != 1:
                raise ValueError(f"a MeshShape of {shape.size} ranks has no "
                                 "process group: pass a DeviceMesh")
            coords = [0] * len(axes)
            self.groups = []
        else:
            coords = [mesh.get_local_rank(a) for a in axes]
            self.groups = [mesh.get_group(a) for a in reversed(axes)]
        self.blocks = self._blocks(n)
        block = 0
        for a, size in zip(coords, self.sizes):
            block = block * size + a
        self.lo, self.hi = self.blocks[block]
        self.width = self.blocks[0][1]          # the widest block, padded to

    def _blocks(self, n: int):
        spans = [(0, n)]
        for size in self.sizes:
            out = []
            for lo, hi in spans:
                c = -(-(hi - lo) // size)
                for i in range(size):
                    a = min(lo + i * c, hi)
                    out.append((a, min(a + c, hi)))
            spans = out
        return spans

    @property
    def n_local(self) -> int:
        return self.hi - self.lo

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        for g in self.groups:
            dist.all_reduce(t, op=op, group=g)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(*shape) on each rank -> (n_blocks, *shape), in block order."""
        out = t[None]
        for g in self.groups:
            parts = [torch.empty_like(out)
                     for _ in range(dist.get_world_size(g))]
            dist.all_gather(parts, out.contiguous(), group=g)
            out = torch.cat(parts)
        return out

    def pad(self, t: torch.Tensor, fill: float) -> torch.Tensor:
        """(R, n_local, ...) -> (R, width, ...), ``fill`` past the end."""
        extra = self.width - t.shape[1]
        if not extra:
            return t
        return torch.cat([t, t.new_full((t.shape[0], extra, *t.shape[2:]),
                                        fill)], 1)

    def unpad(self, gathered: np.ndarray) -> np.ndarray:
        """(n_blocks, R, width) host blocks -> the (R, N) array."""
        return np.concatenate([g[:, :hi - lo] for g, (lo, hi)
                               in zip(gathered, self.blocks)], 1)


def _amax(t: torch.Tensor, empty: float) -> torch.Tensor:
    """Row max of an (R, n) tensor, ``empty`` where n is 0."""
    if t.shape[-1]:
        return t.amax(-1)
    return t.new_full(t.shape[:-1], empty)


def _argmax_pair(t: torch.Tensor, lo: int, n: int):
    """(row max, its first global index) of a rank's columns, as
    ``torch.argmax`` picks it; (-inf, n) on a rank without columns, so
    that any rank's pair wins over it."""
    if not t.shape[-1]:
        return t.new_full(t.shape[:-1], -torch.inf), t.new_full(
            t.shape[:-1], float(n))
    i = t.argmax(-1)
    return t.gather(-1, i[:, None])[:, 0], (i + lo).to(torch.float64)


def _merge_argmax(vals: torch.Tensor, idx: torch.Tensor):
    """(n_blocks, R) pairs -> each row's max and its lowest global index
    among the blocks that reach it: ``torch.argmax``'s first occurrence
    over all N (a NaN is the max, as in ``torch.argmax`` and numpy's)."""
    best = vals.amax(0)
    hit = (vals == best) | (vals.isnan() & best.isnan())
    first = torch.where(hit, idx, torch.inf).amin(0)
    return best, first.to(torch.int64)


def _onehot(cols: torch.Tensor, sh: "_Shard", r: int,
            dev) -> torch.Tensor:
    """(R, k) global column indices -> the rank's (R, n_local) mask of
    those that are its own (another rank's add 0 at a clamped column)."""
    out = torch.zeros((r, sh.n_local), dtype=torch.int32, device=dev)
    if not sh.n_local:
        return out.bool()
    inside = (cols >= sh.lo) & (cols < sh.hi)
    local = (cols - sh.lo).clamp(0, sh.n_local - 1)
    return out.scatter_add(-1, local, inside.to(torch.int32)) > 0


def _merge_prefixes(sh: "_Shard", mine: torch.Tensor, key, costs_f,
                    values, m: int, n: int):
    """The global top-M from each rank's own (R, min(M, n_local)) prefix
    ``mine``: (global index, cost, value) of the first M of the gathered
    candidates in (key, global index) order, (R, M) each, the same on
    every rank."""
    R, m_loc = mine.shape
    cand = torch.stack([key.gather(-1, mine),
                        (mine + sh.lo).to(torch.float64),
                        costs_f.gather(-1, mine),
                        values.gather(-1, mine)], -1)
    # a pad's key is NaN, the last in the order, and its index n follows
    # every real candidate's: no pad enters the prefix ahead of one
    pad = torch.tensor([torch.nan, float(n), 0.0, 0.0], dtype=torch.float64,
                       device=mine.device)
    extra = min(m, sh.width) - m_loc
    cand = torch.cat([cand, pad.expand(R, extra, 4)], 1)
    cand = sh.all_gather(cand).transpose(0, 1).reshape(R, -1, 4)
    cand = cand.gather(1, torch.argsort(cand[..., 1], dim=-1, stable=True)
                       [..., None].expand(-1, -1, 4))
    pos = _topm_prefix_rows(cand[..., 0].contiguous(), m)
    return (cand[..., 1].gather(-1, pos).to(torch.int64),
            cand[..., 2].gather(-1, pos), cand[..., 3].gather(-1, pos))


def _prefilter_device(state: ctl.ControlState, gains, rand_rank, w_rep,
                      w_div, m: int, mesh=None, dev=None):
    """The control plane's device layout (``control._schedule_device``)
    with the walk over the kept prefix, on ``dev`` (the state's device by
    default). Without ``mesh`` one block holds all N columns: no
    collective runs, and the reductions over all N (the fallback's, the
    forced rewrite's) are that layout's own, so the two agree exactly
    whenever the selections do. With a mesh each rank computes on its own
    columns and reduces over N by collectives over the mesh's data axes;
    its outputs are one device's bit for bit.

    Local tensors and explicit collectives (as ``federated/distributed.py``
    runs the cohort step), not DTensor: DTensor's rule for ``topk`` or
    ``argmax`` over a sharded dim first replicates the operands. The
    stages:

      1. Eq. 2's per-metric min and max, ``best_channel``'s max gain: one
         ``all_reduce(MAX)`` (a min as the max of its negation; both
         exact), then Eq. 2/3, Eq. 9 and the keys on the local columns.
         A NaN key sorts last, in index order, as numpy's sort puts it
         (``scheduler.order_key``).
      2. The top-M: in one block the block's own prefix; split, each
         rank's prefix of min(M, n_local) columns, as (key, global index,
         cost, value), gathered, then the prefix of the gathered set in
         (key, global index) order (``_merge_prefixes``). Every member of
         the global prefix is in its rank's own prefix under that order,
         so the two agree, ties at the M-th key included.
      3. The walk over the kept (R, M), the same on every rank.
      4. The certificate's min cost outside the kept set, the fallback's
         and the forced rewrite's argmaxes (max, then the lowest global
         index: ``torch.argmax``'s first occurrence): one gather of a
         rank's (R, 6) row statistics.
      5. The rank's columns of x and alpha, by the elementwise rewrites;
         then, split over ranks, one gather of x, alpha, costs and values
         to full (R, N) host arrays.
    """
    cfg = state.cfg
    K = cfg.n_ues
    n_sel = cfg.min_selected
    R, N = state.reputations.shape
    sh = _Shard(mesh, N)
    cols = slice(sh.lo, sh.hi)
    dev = state.device if dev is None else dev

    def f64(a):
        return torch.as_tensor(np.asarray(a)[:, cols], dtype=torch.float64,
                               device=dev)

    pid = torch.as_tensor(state.policy_id, device=dev)[:, None]
    divs, sizes, ages = f64(state.divs), f64(state.sizes), f64(state.ages)
    g = f64(gains)
    metrics = (divs, sizes, ages)
    stats = torch.stack([s for v in metrics
                         for s in (_amax(-v, -torch.inf),
                                   _amax(v, -torch.inf))]
                        + [_amax(g, -torch.inf)], -1)
    stats = sh.all_reduce(stats, dist.ReduceOp.MAX)
    bounds = [(-stats[:, 2 * i, None], stats[:, 2 * i + 1, None])
              for i in range(3)]
    I = diversity_index_eq2(divs, sizes, ages, cfg.gamma, bounds)
    values = data_quality_value(f64(state.reputations), I, None,
                                omega=(torch.as_tensor(
                                    w_rep, dtype=torch.float64,
                                    device=dev)[:, None],
                                    torch.as_tensor(
                                    w_div, dtype=torch.float64,
                                    device=dev)[:, None]))
    costs = cost_bisect(g, f64(state.r_min), K, cfg.bandwidth_hz,
                        cfg.p_watt, cfg.n0_watt_hz)
    costs_f = costs.to(torch.float64)
    k_f = torch.full_like(costs_f, float(K))
    key = torch.where(
        pid == POLICY_IDS["dqs"], -(values / costs_f),
        torch.where(
            pid == POLICY_IDS["random"], f64(rand_rank),
            torch.where(pid == POLICY_IDS["best_channel"],
                        costs_f * K - g / (stats[:, 6, None] + 1e-12),
                        costs_f)))
    top = pid == POLICY_IDS["top_value"]
    key = torch.where(top, -values, key)

    # the top-M over all N: in one block this rank's own prefix, else
    # the prefix of the ranks' own prefixes
    one_block = len(sh.blocks) == 1
    m_loc = min(m, sh.n_local)
    mine = (_topm_prefix_rows(key, m_loc) if m_loc else
            torch.zeros((R, 0), dtype=torch.int64, device=dev))
    if one_block:
        kept, c_kept, v_kept = mine, costs.gather(-1, mine), None
    else:
        kept, c_kept, v_kept = _merge_prefixes(sh, mine, key, costs_f,
                                               values, m, N)
        c_kept = c_kept.to(costs.dtype)
    take = pack_scan(c_kept, K)
    x = _onehot(torch.where(take, kept, N), sh, R, dev)
    alpha = torch.where(x, costs_f / k_f, 0.0)
    b_rem = K - torch.where(take, c_kept, 0).sum(-1)

    # the row statistics over all N
    kept_here = _onehot(kept, sh, R, dev)
    feas = costs <= K
    masked = torch.where(feas, values, -torch.inf)
    row = torch.stack([
        *_argmax_pair(masked, sh.lo, N), *_argmax_pair(values, sh.lo, N),
        _amax(feas.to(torch.float64), 0.0),
        -_amax(-torch.where(kept_here, K + 2, costs).to(torch.float64),
               -float(K + 2))], -1)
    row = sh.all_gather(row)
    best, k_best = _merge_argmax(row[..., 0], row[..., 1])
    _, k_force = _merge_argmax(row[..., 2], row[..., 3])
    feas_any = row[..., 4].amax(0) > 0
    dmin = row[..., 5].amin(0)
    cert = (b_rem < dmin) | top[:, 0]

    # dqs modified-greedy fallback. In one block the pack's value is the
    # exact layout's own sum over N. Split over ranks it sums the kept
    # values in visit order, (R, M) with 0.0 where not taken, the same on
    # every rank: the same terms among N - M fewer zeros. Adding 0.0 is
    # exact, so the two differ only in the order the taken terms
    # associate: not at all for one or two of them, otherwise within a few
    # ulp of the pack's value, and the comparison with the best single
    # value can only flip inside that gap.
    pack = (torch.where(x, values, 0.0).sum(-1) if one_block
            else torch.where(take, v_kept, 0.0).sum(-1))
    use_fb = ((pid == POLICY_IDS["dqs"]) & feas_any[:, None]
              & (best > pack)[:, None])
    onehot_best = _onehot(k_best[:, None], sh, R, dev)
    x = torch.where(use_fb, onehot_best, x)
    alpha = torch.where(use_fb, torch.where(onehot_best, costs_f / k_f, 0.0),
                        alpha)

    # top_value: the first n_sel of the (-value)-ordered prefix
    xt = _onehot(kept[:, :n_sel], sh, R, dev)
    x = torch.where(top, xt, x)
    alpha = torch.where(top, torch.where(
        xt, torch.full_like(alpha, 1.0 / max(n_sel, 1)), 0.0), alpha)

    # degenerate rounds: no selection is left where the walk took none,
    # the fallback did not fire, and the row is no top_value row
    any_x = torch.where(top[:, 0], n_sel > 0, use_fb[:, 0] | take.any(-1))
    forced = ~any_x[:, None]
    onehot_f = _onehot(k_force[:, None], sh, R, dev)
    x = torch.where(forced, onehot_f, x)
    alpha = torch.where(forced, onehot_f.to(torch.float64), alpha)

    if one_block:
        x, alpha, costs, values = (t.cpu().numpy()
                                   for t in (x, alpha, costs, values))
    else:
        out = torch.stack([x.to(torch.float64), alpha, costs_f, values], -1)
        out = sh.all_gather(sh.pad(out, 0.0)).cpu().numpy()
        x, alpha, costs, values = (sh.unpad(out[..., i]) for i in range(4))
    return (x.astype(bool), alpha, costs.astype(int), values,
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
                            kernel: Optional[str] = None, mesh=None):
    """Schedule round t of all R runs through the top-M prefilter.

    The inputs and outputs of ``control.schedule_runs`` plus an ``info``
    dict: ``(x, alpha, costs, values, forced, info)`` with
    ``info = {"m", "n_escalated"}``. Every run's schedule is the exact
    path's: a row whose certificate holds by the preservation argument (the
    module docstring), a row whose certificate fails by escalation to
    ``schedule_runs`` itself. ``m`` defaults to ``default_m``; ``kernel``
    is "hybrid" | "device" (None: the state's device decides, or "device"
    where ``mesh`` is given).

    ``mesh`` (``population_mesh``; "device" layout only, "hybrid" ignores
    it) splits the population axis over the mesh's data axes: every rank
    of the mesh calls this with the same host arrays, computes on its own
    columns on its device (``_prefilter_device``) and gets the whole
    outputs, bit-equal to the one-device "device" layout's.
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
    kern = ctl._layout(kernel or ("device" if mesh is not None else None),
                       state.device)
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

        args = (state, gains, rand_rank, w_rep, w_div, m_eff)
        if kern == "hybrid":
            outs = _prefilter_hybrid(*args)
        else:
            dev = (state.device if mesh is None or isinstance(mesh, MeshShape)
                   else _mesh_device(mesh))
            outs = _prefilter_device(*args, mesh, dev)
            state = dataclasses.replace(state, device=dev)
        x, alpha, costs, values, forced, cert = outs

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
# The population split over a mesh
# ---------------------------------------------------------------------- #
def _mesh_device(mesh) -> torch.device:
    """This rank's device of a ``DeviceMesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def population_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """The host mesh (``launch.mesh.make_host_mesh``) the population axis
    shards over: ("data", "model") of (ranks // model_parallel,
    model_parallel) over the process group, a ``DeviceMesh``, or a (1, 1)
    ``MeshShape`` without a group. ``device_type="cuda"`` raises without
    CUDA."""
    resolve_device(device_type)
    return make_host_mesh(model_parallel, device_type=device_type)


def shard_population(mesh, *arrays):
    """Place (R, N) control arrays with the population (trailing) axis
    split over the ``DeviceMesh``'s data axes and replicated over "model":
    ``DTensor``s of ``[Shard(1), Replicate()]``, dtypes kept, uneven N
    allowed. Each rank takes its own columns; nothing is communicated."""
    from torch.distributed.tensor import DTensor
    placements = named(mesh, (None, data_axes(mesh)))
    dev = _mesh_device(mesh)
    out = []
    for a in arrays:
        a = np.asarray(a)
        sh = _Shard(mesh, a.shape[1])
        local = torch.as_tensor(a[:, sh.lo:sh.hi], device=dev)
        out.append(DTensor.from_local(local, mesh, placements,
                                      run_check=False, shape=a.shape,
                                      stride=(a.shape[1], 1)))
    return tuple(out) if len(out) != 1 else out[0]


def bytes_per_device(pop: PopulationState, n_devices: int = 1) -> int:
    """Resident population-state bytes a device when the N axis is split
    over ``n_devices`` (the policy ids are on every device)."""
    return pop.nbytes() // max(n_devices, 1) + pop.policy_id.nbytes
