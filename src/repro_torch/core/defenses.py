"""Defense plane: robust aggregation + data-quality validation.

    DefensePolicy — a named bundle of two orthogonal components:
        aggregator  RobustAggregator    replaces/augments FedAvg over the
                                        stacked cohort: coordinate-wise
                                        trimmed mean, coordinate median,
                                        update-norm clipping, Krum /
                                        multi-Krum distance filtering
        detector    ValidationDetector  a held-out validation pass over the
                                        uploaded models whose anomaly score
                                        feeds a trust penalty into Eq. 1

A copy of ``repro.core.defenses``. Every aggregator has a host numpy
oracle over the compressed ``(n, P)`` matrix (``aggregate_host``, which
the tests hold the batched twin to) and a batched twin over the (padded)
``(N, P)`` flattened-update layout (``aggregate_stacked``, on the server's
device — the path of both engines). The trimmed mean and the median of
the batched twin always go through ``kernels.robust_aggregate`` (the
Hopper kernel on a CUDA tensor, its plain version on a CPU one); both
planes sum the kept ranks in one ascending sequential float32 order, so
their payloads are bit-equal. Norm clipping and Krum compute their norms and distances in
float64 on the tensor's device and combine through the stock FedAvg
(``federated.aggregation``, the ``weighted_aggregate`` kernel on the card);
their decisions are bit-equal, their payloads within an ulp.

Defenses draw nothing: they are deterministic functions of the uploaded
cohort, so the host RNG stream of record is untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.robust_aggregate import robust_aggregate

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------- #
# Flattened-update layout helpers (the (N_pad, P) defense layout); leaves
# in sorted key order, the column order of ``flatten_stacked``
# ---------------------------------------------------------------------- #
def flatten_params_np(params: Params) -> np.ndarray:
    """One params dict -> (P,) float32 numpy vector (host layout)."""
    return np.concatenate([
        params[k].detach().cpu().numpy().astype(np.float32).ravel()
        for k in sorted(params)])


def unflatten_vec(template: Params, vec) -> Params:
    """(P,) vector (numpy or tensor) -> params dict shaped like
    ``template``, on its device and in its dtypes."""
    vec = torch.as_tensor(vec)
    out, off = {}, 0
    for k in sorted(template):
        l = template[k]
        m = l.numel()
        out[k] = vec[off:off + m].reshape(l.shape).to(device=l.device,
                                                      dtype=l.dtype)
        off += m
    return out


def unflatten_stacked(stacked_template: Params,
                      flat: torch.Tensor) -> Params:
    """(N, P) matrix -> stacked dict shaped like ``stacked_template``."""
    out, off = {}, 0
    for k in sorted(stacked_template):
        l = stacked_template[k]
        m = l[0].numel()
        out[k] = flat[:, off:off + m].reshape(l.shape).to(l.dtype)
        off += m
    return out


# ---------------------------------------------------------------------- #
# Per-round defense statistics (RoundLog payload)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class DefenseStats:
    """What the defense did this round (metrics only — ground truth never
    feeds back into the defense itself)."""
    n_clipped: int = 0        # norm-clip: rows whose update was shrunk
    n_rejected: int = 0       # trim/Krum: rows excluded from aggregation
    n_flagged: int = 0        # detector: rows with positive anomaly
    det_precision: float = float("nan")   # flagged ∩ malicious / flagged
    det_recall: float = float("nan")      # flagged ∩ malicious / malicious


# ---------------------------------------------------------------------- #
# Robust aggregators
# ---------------------------------------------------------------------- #
def _seq_mean(rows, count):
    """Ascending sequential sum / count — the one accumulation order of
    the host oracle, the plain version and the kernel."""
    acc = rows[0]
    for r in rows[1:]:
        acc = acc + r
    return acc / count


@dataclasses.dataclass(frozen=True)
class TrimmedMean:
    """Coordinate-wise trimmed mean [Yin et al., 2018]: per parameter,
    sort the n uploaded values, drop ``n_trim(n)`` from each end, average
    the rest (unweighted — robust statistics replace the size-weighted
    FedAvg entirely)."""
    trim: float = 0.2      # fraction trimmed from EACH end

    def __post_init__(self):
        if not 0.0 < self.trim < 0.5:
            raise ValueError(f"trim {self.trim} not in (0, 0.5)")

    def n_trim(self, n: int) -> int:
        return min(int(np.floor(self.trim * n)), max((n - 1) // 2, 0))

    def aggregate_host(self, flat: np.ndarray
                       ) -> Tuple[np.ndarray, DefenseStats]:
        """(n, P) float32 compressed matrix -> (P,) aggregate."""
        n = flat.shape[0]
        b = self.n_trim(n)
        xs = np.sort(flat, axis=0)
        agg = _seq_mean([xs[i] for i in range(b, n - b)],
                        np.float32(n - 2 * b))
        return agg, DefenseStats(n_rejected=2 * b)

    def aggregate_batched(self, flat: torch.Tensor, n: int
                          ) -> Tuple[torch.Tensor, DefenseStats]:
        """(N_pad, P) padded matrix (real rows first) -> (P,) aggregate,
        through ``kernels.robust_aggregate``."""
        b = self.n_trim(n)
        return (robust_aggregate(flat, n, trim=b, mode="trimmed_mean"),
                DefenseStats(n_rejected=2 * b))


@dataclasses.dataclass(frozen=True)
class Median:
    """Coordinate-wise median: the midpoint of ranks (n-1)//2 and n//2 —
    exact on both planes (one add and one halving)."""

    def aggregate_host(self, flat: np.ndarray
                       ) -> Tuple[np.ndarray, DefenseStats]:
        n = flat.shape[0]
        xs = np.sort(flat, axis=0)
        agg = (xs[(n - 1) // 2] + xs[n // 2]) * np.float32(0.5)
        return agg, DefenseStats(n_rejected=n - 2 + (n % 2))

    def aggregate_batched(self, flat: torch.Tensor, n: int
                          ) -> Tuple[torch.Tensor, DefenseStats]:
        return (robust_aggregate(flat, n, mode="median"),
                DefenseStats(n_rejected=n - 2 + (n % 2)))


@dataclasses.dataclass(frozen=True)
class NormClip:
    """Update-norm clipping: Delta_k = Omega_k − g is shrunk to L2 norm
    <= tau (norms in float64 on both planes, the scale rounded to float32
    so the elementwise clip is the same on both), then the clipped uploads
    go through the usual size-weighted FedAvg."""
    tau: float = 1.0

    def __post_init__(self):
        if not self.tau > 0:
            raise ValueError(f"tau {self.tau} must be positive")

    def scales_host(self, flat: np.ndarray, g: np.ndarray) -> np.ndarray:
        delta = flat - g[None]
        n2 = np.sum(delta.astype(np.float64) ** 2, axis=1)
        return np.minimum(
            1.0, self.tau / np.maximum(np.sqrt(n2), 1e-12)
        ).astype(np.float32)

    def clip_host(self, flat: np.ndarray, g: np.ndarray
                  ) -> Tuple[np.ndarray, DefenseStats]:
        s = self.scales_host(flat, g)
        clipped = g[None] + s[:, None] * (flat - g[None])
        return clipped, DefenseStats(n_clipped=int((s < 1.0).sum()))

    def clip_batched(self, flat: torch.Tensor, g: torch.Tensor, n: int
                     ) -> Tuple[torch.Tensor, DefenseStats]:
        delta = flat - g[None]
        # the documented exception: the clip norms are float64 on both
        # planes, as the reference's under enable_x64
        # repro: allow(dtype-f64)
        n2 = (delta.to(torch.float64) ** 2).sum(1)
        s = torch.clamp(self.tau / torch.clamp(torch.sqrt(n2), min=1e-12),
                        max=1.0).to(torch.float32)
        clipped = g[None] + s[:, None] * delta
        n_clipped = int((s[:n] < 1.0).sum())
        return clipped, DefenseStats(n_clipped=n_clipped)


@dataclasses.dataclass(frozen=True)
class Krum:
    """Krum / multi-Krum distance filter [Blanchard et al., 2017]: each
    upload is scored by the summed squared distance to its n−f−2 nearest
    neighbours; the ``n_select`` lowest-score uploads survive and go
    through the usual size-weighted FedAvg. Distances and scores in
    float64 on both planes. Degrades to plain FedAvg (nothing rejected)
    when the cohort is too small for the bound (n < f + 3).
    """
    n_select: Optional[int] = None    # None -> n - f (multi-Krum)
    f: Optional[int] = None           # assumed Byzantine count;
    #                                   None -> the server's cfg.n_malicious

    def _resolve(self, n: int, n_byz: int) -> Tuple[int, int]:
        f = self.f if self.f is not None else n_byz
        m = self.n_select if self.n_select is not None else max(n - f, 1)
        return f, min(max(m, 1), n)

    def select_host(self, flat: np.ndarray, n_byz: int) -> np.ndarray:
        """(n, P) -> sorted indices of the selected uploads. Pairwise
        squared distances via the float64 gram matrix."""
        n = flat.shape[0]
        f, m = self._resolve(n, n_byz)
        if n - f - 2 < 1:
            return np.arange(n)
        X = flat.astype(np.float64)
        sq = np.einsum("ij,ij->i", X, X)
        d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (X @ X.T), 0.0)
        np.fill_diagonal(d2, 0.0)             # exact self term
        ds = np.sort(d2, axis=1)              # ds[:, 0] is the self term
        scores = ds[:, 1:n - f - 1].sum(axis=1)
        return np.sort(np.argsort(scores, kind="stable")[:m])

    def select_batched(self, flat: torch.Tensor, n: int,
                       n_byz: int) -> np.ndarray:
        """Padded (N_pad, P) twin — scores only the n real rows, in float64
        on the tensor's device; returns the same sorted index array as the
        host oracle (the gram product's ulps could flip a selection only on
        a score tie)."""
        f, m = self._resolve(n, n_byz)
        if n - f - 2 < 1:
            return np.arange(n)
        # the documented exception: Krum's distances are float64 on both
        # planes, as the reference's under enable_x64
        # repro: allow(dtype-f64)
        X = flat[:n].to(torch.float64)
        sq = (X * X).sum(1)
        d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (X @ X.T),
                         min=0.0)
        d2.fill_diagonal_(0.0)
        ds = torch.sort(d2, dim=1).values
        scores = ds[:, 1:n - f - 1].sum(1).cpu().numpy()
        return np.sort(np.argsort(scores, kind="stable")[:m])


RobustAggregator = Union[TrimmedMean, Median, NormClip, Krum]


# ---------------------------------------------------------------------- #
# Aggregation entry points (the two engines route through these)
# ---------------------------------------------------------------------- #
def aggregate_host(agg: RobustAggregator, params_list: List[Params],
                   weights: np.ndarray, global_params: Params, n_byz: int):
    """Host numpy oracle over a compressed list of uploaded params dicts
    (the reference's loop-engine path; the server aggregates through
    ``aggregate_stacked``). Returns (new global params, stats).
    The filtering/clipping aggregators combine through the stock
    ``fedavg``."""
    # imported here: the federated package imports this one
    from repro_torch.federated.aggregation import fedavg
    weights = np.asarray(weights, float)
    flat = np.stack([flatten_params_np(p) for p in params_list])
    if isinstance(agg, (TrimmedMean, Median)):
        vec, stats = agg.aggregate_host(flat)
        return unflatten_vec(global_params, vec), stats
    if isinstance(agg, NormClip):
        clipped, stats = agg.clip_host(flat,
                                       flatten_params_np(global_params))
        rows = [unflatten_vec(global_params, clipped[i])
                for i in range(clipped.shape[0])]
        return fedavg(rows, weights), stats
    if not isinstance(agg, Krum):
        raise TypeError(f"not a robust aggregator: {agg!r}")
    sel = agg.select_host(flat, n_byz)
    stats = DefenseStats(n_rejected=len(params_list) - sel.size)
    return fedavg([params_list[i] for i in sel], weights[sel]), stats


def aggregate_stacked(agg: RobustAggregator, stacked: Params,
                      weights: np.ndarray, global_params: Params, n: int,
                      n_byz: int):
    """Batched twin over the stacked cohort (leaves (N, ...), the n real
    rows first, any padding weight 0) — the defense path of both engines,
    on the cohort's device. Returns (new global params, stats)."""
    # imported here: the federated package imports this one
    from repro_torch.federated.aggregation import (fedavg_stacked,
                                                   flatten_stacked)
    weights = np.asarray(weights, float)
    flat = flatten_stacked(stacked)
    if isinstance(agg, (TrimmedMean, Median)):
        vec, stats = agg.aggregate_batched(flat, n)
        return unflatten_vec(global_params, vec), stats
    if isinstance(agg, NormClip):
        g = flatten_stacked({k: v[None] for k, v in global_params.items()})
        clipped, stats = agg.clip_batched(flat, g[0], n)
        return fedavg_stacked(unflatten_stacked(stacked, clipped),
                              weights), stats
    if not isinstance(agg, Krum):
        raise TypeError(f"not a robust aggregator: {agg!r}")
    sel = agg.select_batched(flat, n, n_byz)
    stats = DefenseStats(n_rejected=n - sel.size)
    w = np.zeros_like(weights)
    w[sel] = weights[sel]
    return fedavg_stacked(stacked, w), stats


# ---------------------------------------------------------------------- #
# Validation detector (the unreliable-data family, arXiv:2102.09491)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ValidationDetector:
    """Server-side validation pass over the uploaded models: every
    scheduled UE's upload — and the start-of-round GLOBAL model — is scored
    on a held-out validation split (the first ``n_val`` rows of the public
    test set, clamped to its size) restricted to the classes the UE claims
    to hold. The anomaly score is the upload's degradation of its own
    claimed classes relative to the global model:

        a_k = max(0, v_global,k − v_k − tol)

    and ``weight * a_k`` enters Eq. 1 as a trust penalty (an extra
    subtracted term inside the same clip). Flags (a_k > 0) are metrics
    only; ground truth never feeds back.
    """
    n_val: int = 1000
    tol: float = 0.1
    weight: float = 5.0

    def __post_init__(self):
        if not (self.n_val >= 1 and self.tol >= 0 and self.weight >= 0):
            raise ValueError((self.n_val, self.tol, self.weight))

    def anomaly(self, acc_val: np.ndarray) -> np.ndarray:
        """acc_val (2, n): row 0 = per-upload masked validation accuracy,
        row 1 = the global model's accuracy on the same masks."""
        v, g = np.asarray(acc_val, float)
        return np.maximum(g - v - self.tol, 0.0)

    def penalties(self, acc_val: np.ndarray) -> np.ndarray:
        return self.weight * self.anomaly(acc_val)


def detection_stats(flags: np.ndarray, truth: np.ndarray) -> Tuple[float,
                                                                   float]:
    """(precision, recall) of the flagged set against the ground-truth
    malicious mask over the round's cohort (NaN when undefined)."""
    flags = np.asarray(flags, bool)
    truth = np.asarray(truth, bool)
    tp = float((flags & truth).sum())
    prec = tp / flags.sum() if flags.any() else float("nan")
    rec = tp / truth.sum() if truth.any() else float("nan")
    return prec, rec


# ---------------------------------------------------------------------- #
# DefensePolicy: the composite defense + registry
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class DefensePolicy:
    """A named defense: robust aggregator + validation detector. Either
    may be None; all-None is the undefended control (``"none"``)."""
    name: str
    aggregator: Optional[RobustAggregator] = None
    detector: Optional[ValidationDetector] = None

    @property
    def benign(self) -> bool:
        return self.aggregator is None and self.detector is None


DEFENSES: Dict[str, DefensePolicy] = {}


def register(defense: DefensePolicy) -> DefensePolicy:
    if defense.name in DEFENSES:
        raise ValueError(f"defense {defense.name!r} already registered")
    DEFENSES[defense.name] = defense
    return defense


def trimmed_mean(trim: float = 0.2,
                 name: Optional[str] = None) -> DefensePolicy:
    name = name or ("trimmed_mean" if trim == 0.2
                    else f"trimmed_mean_{int(round(trim * 100))}")
    return DefensePolicy(name, aggregator=TrimmedMean(trim))


def median(name: Optional[str] = None) -> DefensePolicy:
    return DefensePolicy(name or "median", aggregator=Median())


def norm_clip(tau: float = 1.0,
              name: Optional[str] = None) -> DefensePolicy:
    name = name or ("norm_clip" if tau == 1.0 else f"norm_clip_{tau:g}")
    return DefensePolicy(name, aggregator=NormClip(tau))


def krum(n_select: Optional[int] = None, f: Optional[int] = None,
         name: Optional[str] = None) -> DefensePolicy:
    return DefensePolicy(name or "krum", aggregator=Krum(n_select, f))


def validation(n_val: int = 1000, tol: float = 0.1, weight: float = 5.0,
               name: Optional[str] = None) -> DefensePolicy:
    return DefensePolicy(name or "validation",
                         detector=ValidationDetector(n_val, tol, weight))


def with_validation(base: DefensePolicy,
                    det: Optional[ValidationDetector] = None,
                    name: Optional[str] = None) -> DefensePolicy:
    """Compose a detector onto an aggregator-only defense."""
    return dataclasses.replace(
        base, name=name or f"{base.name}+validation",
        detector=det or ValidationDetector())


NO_DEFENSE = register(DefensePolicy("none"))
register(trimmed_mean(0.2))
register(median())
register(norm_clip(1.0))
register(krum())
register(validation())
register(with_validation(trimmed_mean(0.2)))


def as_defense(spec) -> DefensePolicy:
    """Coerce a defense spec: DefensePolicy passes through, str looks up
    the registry, None is the undefended control."""
    if spec is None:
        return NO_DEFENSE
    if isinstance(spec, DefensePolicy):
        return spec
    if isinstance(spec, str):
        return DEFENSES[spec]
    raise TypeError(f"not a defense policy spec: {spec!r}")
