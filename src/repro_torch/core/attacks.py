"""Threat-model plane, the part the server touches on the main path.

``AttackScenario`` here carries only the activity schedule and the watched
(source, target) pair: the label flip itself is baked into the clients by
the partition (``core.poisoning.LabelFlipAttack``), and the model/report
attack components of ``repro.core.attacks`` arrive with the attack-plane
slice. ``MaliciousSchedule`` gates the clean-twin rows of label-flipped
clients (see ``federated.server.CohortData``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class MaliciousSchedule:
    """Round-dependent activity of the malicious set.

    always       — every malicious UE attacks every round.
    intermittent — all attack only when ``t % period < duty``.
    roundrobin   — colluding rotation: the malicious set splits into
                   ``period`` groups by rank and group ``t % period``
                   attacks in round t.

    A label-flipped UE that is inactive in round t trains on its clean
    twin in that round.
    """
    kind: str = "always"      # always | intermittent | roundrobin
    period: int = 1
    duty: int = 1

    def __post_init__(self):
        if self.kind not in ("always", "intermittent", "roundrobin"):
            raise ValueError(f"unknown schedule kind {self.kind!r}")
        if not (self.period >= 1 and 1 <= self.duty <= self.period):
            raise ValueError((self.period, self.duty))

    def active(self, t: int, mal_mask: np.ndarray,
               mal_rank: np.ndarray) -> np.ndarray:
        """(K,) bool — the malicious UEs acting in round ``t``.

        mal_mask — (K,) bool malicious flags; mal_rank — (K,) rank of
        each UE within the malicious set (-1 for honest UEs).
        """
        if self.kind == "always":
            return mal_mask
        if self.kind == "intermittent":
            if t % self.period < self.duty:
                return mal_mask
            return np.zeros_like(mal_mask)
        return mal_mask & (mal_rank % self.period == t % self.period)


ALWAYS = MaliciousSchedule()


@dataclasses.dataclass(frozen=True)
class AttackScenario:
    """A named threat model: the activity schedule and the watched
    (source, target) pair the metrics track (``source_acc``, attack success
    rate). ``model`` and ``report`` stay None until the attack-plane slice
    ports them."""
    name: str
    model: None = None
    report: None = None
    schedule: MaliciousSchedule = ALWAYS
    watch: Optional[Tuple[int, int]] = None

    def __post_init__(self):
        if self.model is not None or self.report is not None:
            raise NotImplementedError(
                "model and report attacks are ported with the attack-plane "
                "slice")


def reputation_gap(reputations: np.ndarray, mal_mask: np.ndarray) -> float:
    """Honest-vs-malicious reputation separation: mean honest reputation
    minus mean malicious reputation (NaN when either set is empty)."""
    mal_mask = np.asarray(mal_mask, bool)
    if not mal_mask.any() or mal_mask.all():
        return float("nan")
    return float(np.mean(reputations[~mal_mask])
                 - np.mean(reputations[mal_mask]))
