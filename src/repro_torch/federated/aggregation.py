"""FedAvg aggregation (Alg. 1 line 13): g <- sum_k (D_k / D_t) * Omega_k.

The list form (``fedavg``) stacks and calls the stacked form
(``fedavg_stacked``), so the two agree bit for bit. Weights are normalised
in float64 on the host and rounded once to float32; the stacked params are
flattened into one (N, M) matrix — leaves in sorted key order (b1, b2, w1,
w2), the column order of the JAX package's flattening — and reduced by
``kernels.weighted_aggregate`` (the Hopper kernel on a CUDA tensor).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.weighted_aggregate import weighted_aggregate

Params = Dict[str, torch.Tensor]


def normalize_weights(weights, device: DeviceLike = None) -> torch.Tensor:
    """(N,) weights -> (N,) float32 fractions summing to 1, normalised in
    float64 on the host, then one rounding to float32, on ``device`` (None:
    the GPU, which raises without CUDA)."""
    device = resolve_device(device)
    w = np.asarray(weights, np.float64)
    s = w.sum()
    if not s > 0:
        raise ValueError(f"empty aggregation: weights sum to {s}")
    return torch.from_numpy((w / s).astype(np.float32)).to(device)


def fedavg(updates: Sequence[Params], weights: Sequence[float]) -> Params:
    """Weighted average of parameter dicts (list form)."""
    stacked = {k: torch.stack([u[k] for u in updates]) for k in updates[0]}
    return fedavg_stacked(stacked, weights)


def flatten_stacked(stacked: Params) -> torch.Tensor:
    """The (N, M) float32 matrix of a stacked params dict: each leaf
    reshaped to (N, -1), leaves side by side in sorted key order."""
    n = next(iter(stacked.values())).shape[0]
    return torch.cat([stacked[k].reshape(n, -1).to(torch.float32)
                      for k in sorted(stacked)], dim=1)


def fedavg_stacked(stacked: Params, weights) -> Params:
    """Aggregate updates stacked on axis 0 (device-cohort layout):
    leaf (N, ...) x weights (N,) -> (...)."""
    flat = flatten_stacked(stacked)
    w = normalize_weights(weights, flat.device)
    agg = weighted_aggregate(flat, w, assume_normalized=True)
    return unflatten(agg, {k: v[0] for k, v in stacked.items()})


def unflatten(vec: torch.Tensor, like: Params) -> Params:
    """The inverse of one row of ``flatten_stacked``: ``vec`` (M,) cut
    into ``like``'s leaves in sorted key order, each reshaped to its leaf
    and cast to its dtype."""
    out, off = {}, 0
    for k in sorted(like):
        m = like[k].numel()
        out[k] = vec[off:off + m].reshape(like[k].shape).to(like[k].dtype)
        off += m
    return out
