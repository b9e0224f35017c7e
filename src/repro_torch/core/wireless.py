"""Wireless edge model (paper §III-C, Eq. 4-7, 9), host numpy in float64.

OFDMA uplink from K UEs to one BS at the centre of a square cell. Channel
gain = large-scale pathloss x Rayleigh small-scale fading:
``|g_k|^2 = d_k^-alpha |h_k|^2``. Achievable rate with bandwidth fraction
``a_k`` (Eq. 4):

    r_k = a_k B log2(1 + g_k P_k / (a_k B N0))

Round deadline T bounds ``t_train + t_up`` (Eq. 5); training time follows the
cycles/bit model (Eq. 6); upload time ``t_up = s / r_k`` (Eq. 7). The DQS
bandwidth *cost* c_k (Eq. 9) is the minimum number of uniform 1/K fractions
that meets the UE's minimum rate, found by monotone bisection (r_k(c/K) is
strictly increasing in c); ``cost_scan`` keeps the exhaustive scan as the
test oracle.

A copy of the host ``WirelessModel`` of ``repro.core.wireless``: the same
RNG draws in the same order, and the same float64 arithmetic, so costs and
channel gains are equal to the reference's exactly. ``rate_eq4`` and
``cost_bisect`` are the batched control plane's tensor twins
(core/control.py): float64 over (..., K) tensors on any device, every
quotient by a tensor (CUDA divides by a host scalar as a product with its
reciprocal, which is not the IEEE quotient numpy computes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import FeelConfig, dbm_to_watt  # noqa: F401
# dbm_to_watt is defined beside FeelConfig's p_watt / n0_watt_hz and
# re-exported here, as the JAX package's wireless module does


@dataclasses.dataclass
class ChannelState:
    """Per-round channel realisation for K UEs."""
    gains: np.ndarray          # |g_k|^2, linear
    distances: np.ndarray      # d_k in metres

    @property
    def k(self) -> int:
        return self.gains.shape[0]


class WirelessModel:
    def __init__(self, cfg: FeelConfig, rng: np.random.Generator):
        self.cfg = cfg
        self.rng = rng
        half = cfg.cell_side_m / 2.0
        # one position per candidate; Eq. 9's budget stays cfg.n_ues
        xy = rng.uniform(-half, half, size=(cfg.n_population, 2))
        self.distances = np.maximum(np.linalg.norm(xy, axis=1), 1.0)
        self.p_watt = cfg.p_watt
        self.n0 = cfg.n0_watt_hz     # W/Hz
        # AR(1)/Gauss-Markov fading state: complex h per candidate,
        # components N(0, 1/2) so |h|^2 is stationary Exp(1). Only touched
        # when cfg.channel_corr > 0.
        self._h: Optional[np.ndarray] = None       # (N, 2) re/im
        self.last_gains: Optional[np.ndarray] = None

    def draw_channels(self) -> ChannelState:
        """Rayleigh |h|^2 ~ Exp(1); gains = d^-alpha |h|^2.

        With ``cfg.channel_corr = rho > 0`` the small-scale component is a
        per-UE Gauss-Markov process ``h_t = rho h_{t-1} + sqrt(1-rho^2) w_t``
        (w complex, components N(0, 1/2)). rho = 0 draws one exponential
        variate per UE.
        """
        rho = self.cfg.channel_corr
        if rho == 0.0:
            h2 = self.rng.exponential(1.0, size=self.distances.shape)
        else:
            w = self.rng.standard_normal(self.distances.shape + (2,)) \
                * np.sqrt(0.5)
            if self._h is None:
                self._h = w
            else:
                self._h = rho * self._h + np.sqrt(1.0 - rho * rho) * w
            h2 = (self._h ** 2).sum(axis=-1)
        gains = self.distances ** (-self.cfg.pathloss_exp) * h2
        self.last_gains = gains
        return ChannelState(gains=gains, distances=self.distances)

    # ------------------------------------------------------------------ #
    # Eq. 4 / 7 / 6
    # ------------------------------------------------------------------ #
    def rate(self, gains: np.ndarray, alpha: np.ndarray) -> np.ndarray:
        """Eq. 4 — vectorised; rate is 0 where alpha == 0."""
        cfg = self.cfg
        alpha = np.asarray(alpha, float)
        with np.errstate(divide="ignore", invalid="ignore"):
            snr = gains * self.p_watt / (alpha * cfg.bandwidth_hz * self.n0)
            r = alpha * cfg.bandwidth_hz * np.log2(1.0 + snr)
        return np.where(alpha > 0, r, 0.0)

    def upload_time(self, gains, alpha) -> np.ndarray:
        r = self.rate(gains, alpha)
        with np.errstate(divide="ignore"):
            return np.where(r > 0, self.cfg.model_size_bits / r, np.inf)

    def train_time(self, dataset_sizes: np.ndarray,
                   cpu_hz: np.ndarray) -> np.ndarray:
        """Eq. 6: t = eps * |D_k| * zeta / f."""
        cfg = self.cfg
        bits = dataset_sizes * cfg.sample_bits
        return cfg.local_epochs * bits * cfg.cycles_per_bit / cpu_hz

    # ------------------------------------------------------------------ #
    # Eq. 9 — bandwidth cost in uniform 1/K fractions
    # ------------------------------------------------------------------ #
    def min_rate(self, train_times: np.ndarray) -> np.ndarray:
        """r_min = s / (T - t_train); inf when the deadline is already blown."""
        slack = self.cfg.deadline_s - train_times
        with np.errstate(divide="ignore"):
            return np.where(slack > 0, self.cfg.model_size_bits / slack, np.inf)

    def cost(self, gains: np.ndarray, train_times: np.ndarray) -> np.ndarray:
        """c_k = min{c in [1,K] : r_k(c/K) >= r_min}; K+1 when infeasible.

        Binary search over the integers [1, K]; infeasibility (including a
        blown deadline, r_min = inf) is decided up front by probing the
        whole band (c = K).
        """
        K = self.cfg.n_ues
        r_min = self.min_rate(train_times)                      # (K,)
        feasible = self.rate(gains, np.ones_like(gains)) >= r_min
        lo = np.ones(gains.shape, int)
        hi = np.full(gains.shape, K, int)
        while np.any(lo < hi):
            mid = (lo + hi) // 2
            ok = self.rate(gains, mid / K) >= r_min
            lo = np.where(ok, lo, mid + 1)
            hi = np.where(ok, mid, hi)
        return np.where(feasible, lo, K + 1).astype(int)

    def cost_scan(self, gains: np.ndarray,
                  train_times: np.ndarray) -> np.ndarray:
        """Exhaustive Eq. 9 over a dense (K, K) rate matrix — the O(K^2)
        test oracle for ``cost``."""
        K = self.cfg.n_ues
        r_min = self.min_rate(train_times)                      # (K,)
        cs = np.arange(1, K + 1) / K                            # (K,) fractions
        rates = self.rate(gains[:, None], cs[None, :])          # (K, K)
        feasible = rates >= r_min[:, None]
        c = np.where(feasible.any(1), feasible.argmax(1) + 1, K + 1)
        return c.astype(int)


# ---------------------------------------------------------------------- #
# Tensor twins (batched control plane) — arbitrary leading batch axes.
# ---------------------------------------------------------------------- #
def rate_eq4(gains: torch.Tensor, alpha: torch.Tensor, bandwidth_hz: float,
             p_watt: float, n0: float) -> torch.Tensor:
    """Eq. 4 over float64 tensors, in ``WirelessModel.rate``'s operation
    order; 0 where alpha == 0 (the inf/nan the division makes there is
    discarded by the where)."""
    snr = gains * p_watt / (alpha * bandwidth_hz * n0)
    return torch.where(alpha > 0,
                       alpha * bandwidth_hz * torch.log2(1.0 + snr), 0.0)


def cost_bisect(gains: torch.Tensor, r_min: torch.Tensor, k: int,
                bandwidth_hz: float, p_watt: float,
                n0: float) -> torch.Tensor:
    """Eq. 9 by monotone bisection over (..., K) float64 tensors -> int32.

    ``k`` is the fraction denominator (cfg.n_ues). The loop runs a fixed
    ceil(log2 k) + 1 rounds: once the bracket collapses the extra rounds
    are no-ops for feasible UEs, and an infeasible UE (the whole band
    misses r_min, a blown deadline included) gets k + 1 from the up-front
    whole-band probe.
    """
    kt = torch.full((), float(k), dtype=torch.float64, device=gains.device)

    def ok(c):
        return rate_eq4(gains, c.to(torch.float64) / kt, bandwidth_hz,
                        p_watt, n0) >= r_min

    lo = torch.ones(gains.shape, dtype=torch.int32, device=gains.device)
    hi = torch.full_like(lo, k)
    feasible = ok(hi)
    for _ in range(max(1, math.ceil(math.log2(max(k, 2)))) + 1):
        mid = (lo + hi) // 2
        hit = ok(mid)
        lo, hi = torch.where(hit, lo, mid + 1), torch.where(hit, mid, hi)
    return torch.where(feasible, lo, k + 1).to(torch.int32)
