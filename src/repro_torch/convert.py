"""Carry parameter dicts between numpy arrays and the port's tensors.

The parity tests take the JAX package's parameters as numpy arrays
(``np.asarray`` of each leaf) into the port with ``params_from_numpy`` and
bring the port's back with ``params_to_numpy``; keys, shapes and dtypes are
kept.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def params_from_numpy(d: Mapping[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in d.items()}


def params_to_numpy(p: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in p.items()}
