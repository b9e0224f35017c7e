"""Data poisoning attacks (paper §III-B.1).

Label-flipping: the adversary changes labels of a *source* class to a
*target* class while leaving features untouched — hard to detect from the
update alone. The paper studies the easiest and hardest MNIST pairs from
[Shen et al., ACSAC'16] / [Cao et al., ICPADS'19]: (6 -> 2) and (8 -> 4).

A copy of ``repro.core.poisoning``: the label flip is numpy and draws from
the RNG exactly as the reference does; the model poisoning is a torch op on
``{name: tensor}`` params.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

EASY_PAIR = (6, 2)
HARD_PAIR = (8, 4)


@dataclasses.dataclass(frozen=True)
class LabelFlipAttack:
    source: int
    target: int
    flip_fraction: float = 1.0    # fraction of source-class samples flipped

    def apply(self, labels: np.ndarray,
              rng: np.random.Generator) -> np.ndarray:
        out = labels.copy()
        idx = np.flatnonzero(out == self.source)
        if self.flip_fraction < 1.0 and idx.size:
            n = int(round(self.flip_fraction * idx.size))
            idx = rng.choice(idx, size=n, replace=False)
        out[idx] = self.target
        return out


def pick_malicious(n_ues: int, n_malicious: int,
                   rng: np.random.Generator) -> np.ndarray:
    """Paper §V-A: in each run, n_malicious UEs chosen at random."""
    return rng.choice(n_ues, size=n_malicious, replace=False)


@dataclasses.dataclass(frozen=True)
class ModelPoisonAttack:
    """Model-poisoning (the paper's §VI future-work item): the malicious UE
    manipulates its *update* rather than its data —
    ``Omega' = g + scale * (Omega - g)``. scale = -1 is a sign-flip
    (gradient-ascent) attack; |scale| >> 1 is a boosted/backdoor-style
    attack. The server's legacy ``model_poison=`` knob takes one of these
    and runs it as ``core.attacks.ModelAttack(scale)``."""
    scale: float = -1.0

    def apply(self, global_params: Dict[str, torch.Tensor],
              local_params: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        return {k: global_params[k]
                + self.scale * (local_params[k] - global_params[k])
                for k in local_params}
