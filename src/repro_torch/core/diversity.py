"""Dataset diversity evaluation (paper §III-B.3, Eq. 2), host numpy in f64.

``I_k = sum_i gamma_i * v_i`` over normalised metrics
i in {elements diversity, dataset size, age}. For classification the elements
diversity is the Gini-Simpson index over label frequencies (paper §V-B.1,
following [10] arXiv:2102.09491).

The same arithmetic, in the same order, as the numpy half of
``repro.core.diversity``, so the two agree bit for bit. ``normalize_last``
and ``diversity_index_eq2`` are the batched control plane's tensor twins
(core/control.py), over a trailing UE axis with leading run axes.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


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


def normalize_rows(values: np.ndarray) -> np.ndarray:
    """Min-max normalise a metric to [0, 1] along the last (UE) axis, any
    leading (run) axes; a span below 1e-12 maps every UE to 1."""
    values = np.asarray(values, float)
    lo = values.min(-1, keepdims=True)
    hi = values.max(-1, keepdims=True)
    span = hi - lo
    return np.where(span < 1e-12, 1.0,
                    (values - lo) / np.where(span < 1e-12, 1.0, span))


def diversity_index_rows(element_diversity, dataset_sizes, ages,
                         gamma) -> np.ndarray:
    """Eq. 2 over (..., K) numpy arrays; the three weighted terms
    accumulate left to right, the order every twin keeps."""
    return (gamma[0] * normalize_rows(element_diversity)
            + gamma[1] * normalize_rows(dataset_sizes)
            + gamma[2] * normalize_rows(ages))


def diversity_index(element_diversity: np.ndarray,
                    dataset_sizes: np.ndarray,
                    ages: np.ndarray,
                    gamma: Sequence[float]) -> np.ndarray:
    """Eq. 2 across all K UEs. ``ages`` = rounds since last participation
    (higher -> staler -> more valuable to refresh)."""
    return diversity_index_rows(element_diversity, dataset_sizes, ages,
                                np.asarray(gamma, float))


def normalize_last(values: torch.Tensor, bounds=None) -> torch.Tensor:
    """``normalize_rows`` over a float64 tensor, any device. ``bounds``,
    a pair of (..., 1) tensors, replaces the row's min and max: the whole
    population's, where the row is one rank's shard of it."""
    if bounds is None:
        bounds = values.amin(-1, keepdim=True), values.amax(-1, keepdim=True)
    lo, hi = bounds
    span = hi - lo
    return torch.where(span < 1e-12, 1.0,
                       (values - lo) / torch.where(span < 1e-12, 1.0, span))


def diversity_index_eq2(element_diversity: torch.Tensor,
                        dataset_sizes: torch.Tensor, ages: torch.Tensor,
                        gamma: Sequence[float],
                        bounds=(None, None, None)) -> torch.Tensor:
    """``diversity_index_rows`` over float64 tensors, in the same
    left-to-right order; ``bounds`` are ``normalize_last``'s, one a
    metric."""
    return (gamma[0] * normalize_last(element_diversity, bounds[0])
            + gamma[1] * normalize_last(dataset_sizes, bounds[1])
            + gamma[2] * normalize_last(ages, bounds[2]))
