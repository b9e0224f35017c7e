"""Data-quality value (paper §III-B.4, Eq. 3): V_k = w1 * R_k + w2 * I_k.

``data_quality_value`` is a pure elementwise expression: the host oracle
calls it on numpy arrays, the batched control plane (core/control.py) on
(R, K) arrays or tensors with per-run (R, 1) weights.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.configs.base import FeelConfig


def data_quality_value(reputation, diversity, cfg: FeelConfig,
                       omega: Optional[Tuple[float, float]] = None):
    """Eq. 3. ``omega = (w_rep, w_div)`` overrides the config weights (the
    adaptive-omega schedule passes its annealed pair here, the batched
    control plane its (R, 1) columns; ``cfg`` is then unused)."""
    w_rep, w_div = omega if omega is not None else (cfg.omega_rep,
                                                   cfg.omega_div)
    return w_rep * reputation + w_div * diversity


def adaptive_weights(round_t: int, total_rounds: int,
                     cfg: FeelConfig) -> Tuple[float, float]:
    """Beyond-paper extension motivated by the paper's §V-B.2 observation:
    diversity matters early, reputation matters late. Linearly anneals the
    reputation weight from a quarter to three quarters of
    ``omega_rep + omega_div`` over training; returns ``(w_rep, w_div)``.
    """
    frac = round_t / max(total_rounds - 1, 1)
    total = cfg.omega_rep + cfg.omega_div
    w_rep = total * (0.25 + 0.5 * frac)
    return w_rep, total - w_rep
