"""Dataset diversity evaluation (paper §III-B.3, Eq. 2), host numpy in f64.

``I_k = sum_i gamma_i * v_i`` over normalised metrics
i in {elements diversity, dataset size, age}. For classification the elements
diversity is the Gini-Simpson index over label frequencies (paper §V-B.1,
following [10] arXiv:2102.09491).

The same arithmetic, in the same order, as the numpy half of
``repro.core.diversity``, so the two agree bit for bit.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def gini_simpson(labels: np.ndarray, n_classes: int) -> float:
    """1 - sum p_c^2; 0 for a single-class set, (C-1)/C for uniform."""
    return gini_simpson_hist(np.bincount(labels.astype(int),
                                         minlength=n_classes))


def gini_simpson_hist(counts: np.ndarray) -> float:
    """``gini_simpson`` from a precomputed histogram (the LM task's token
    histogram of a client's windows); 0.0 for an empty histogram."""
    counts = np.asarray(counts, float)
    total = counts.sum()
    if total == 0:
        return 0.0
    p = counts / total
    return float(1.0 - np.sum(p * p))


def normalize(values: np.ndarray) -> np.ndarray:
    """Min-max normalise a metric to [0, 1] along the last (UE) axis; a
    span below 1e-12 maps every UE to 1."""
    values = np.asarray(values, float)
    lo = values.min(-1, keepdims=True)
    hi = values.max(-1, keepdims=True)
    span = hi - lo
    return np.where(span < 1e-12, 1.0,
                    (values - lo) / np.where(span < 1e-12, 1.0, span))


def diversity_index(element_diversity: np.ndarray,
                    dataset_sizes: np.ndarray,
                    ages: np.ndarray,
                    gamma: Sequence[float]) -> np.ndarray:
    """Eq. 2 across all K UEs. ``ages`` = rounds since last participation
    (higher -> staler -> more valuable to refresh). The three weighted
    terms accumulate left to right, as in the reference."""
    gamma = np.asarray(gamma, float)
    return (gamma[0] * normalize(element_diversity)
            + gamma[1] * normalize(dataset_sizes)
            + gamma[2] * normalize(ages))
