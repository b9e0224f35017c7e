"""UE reputation (paper §III-B.2, Eq. 1), host numpy in f64.

    R_k^t = R_k^{t-1} - eta * ( beta1 * (acc_local - avg(acc))
                              + beta2 * (acc_local - acc_test) )

Reputation drops when a UE uploads a bad / poisoned model (its test accuracy
trails the cohort) or when it over-reports its local accuracy versus the
server-side test-set evaluation. Reputations start at 1 (Alg. 1 line 4) and
are clipped to [0, 1]. Both deltas are subtracted, as Eq. 1 is written (the
sign audit is in ``repro.core.reputation``). ``reputation_update_eq1`` is
the batched control plane's tensor twin of ``ReputationTracker.update``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import FeelConfig


def reputation_update_eq1(values: torch.Tensor, sel_mask: torch.Tensor,
                          acc_local: torch.Tensor, acc_test: torch.Tensor,
                          eta: float, beta1: float, beta2: float,
                          penalty=None) -> torch.Tensor:
    """Eq. 1 over (..., K) float64 tensors (the host oracle is
    ``ReputationTracker.update``).

    ``sel_mask`` — {0,1} participation mask; ``acc_local`` / ``acc_test``
    — per-UE accuracies scattered to the full K axis (entries of
    unscheduled UEs are ignored). The cohort average of the beta1 term runs
    over the participants only, and only participants' reputations move
    (then clip to [0, 1]). ``penalty`` — optional (..., K) extra subtracted
    term inside the same clip (the validation detector's trust penalty).
    """
    m = sel_mask.to(values.dtype)
    n = m.sum(-1, keepdim=True)
    avg = (acc_local * m).sum(-1, keepdim=True) / n.clamp_min(1.0)
    delta = eta * (beta1 * (acc_local - avg)
                   + beta2 * (acc_local - acc_test))
    if penalty is not None:
        delta = delta + penalty
    return torch.where(m > 0, (values - delta).clamp(0.0, 1.0), values)


class ReputationTracker:
    def __init__(self, cfg: FeelConfig):
        self.cfg = cfg
        self.values = np.ones(cfg.n_population)

    def update(self, participants: np.ndarray,
               acc_local: np.ndarray, acc_test: np.ndarray,
               penalty=None) -> np.ndarray:
        """Apply Eq. 1 to the participating UEs of this round.

        participants — indices; acc_local — self-reported accuracies
        (len == len(participants)); acc_test — server-measured accuracies of
        the uploaded models on the held-out test set; penalty — optional
        per-participant trust penalty of the defense plane's validation
        detector, subtracted inside the same clip.
        """
        cfg = self.cfg
        if len(participants) == 0:
            return self.values
        avg_acc = float(np.mean(acc_local))
        delta = cfg.eta * (cfg.beta1 * (acc_local - avg_acc)
                           + cfg.beta2 * (acc_local - acc_test))
        if penalty is not None:
            delta = delta + penalty
        self.values[participants] = np.clip(
            self.values[participants] - delta, 0.0, 1.0)
        return self.values
