"""Vectorized cohort execution engine (Alg. 1, all scheduled UEs at once).

The round's cohort is stacked into (N, max_samples, ...) tensors (see
``data.partition.pad_clients`` for the padding/masking contract) and all N
local trainings run together with an explicit client axis:

    cohort_train — masked epochs + masked local metric on the stacked
        cohort; the global params are broadcast to every client, and the
        per-client trained params come back stacked on axis 0, ready for
        ``fedavg_stacked`` / the ``weighted_aggregate`` kernel. Forward
        passes are one batched matmul per layer; autograd runs on the sum
        of the per-client losses, whose terms are disjoint, so each client
        gets its own gradient.
    cohort_eval  — one batched pass scoring every uploaded model on the
        (per-UE masked) public test set (Alg. 1 line 14).
    cohort_train_multi / cohort_eval_rows — the sweep runner's twins
        (federated/simulation.py): per-row params, so rows of different
        runs train in one call, and per-row unit labels, so the attack
        success rate scores beside the accuracy in one call.

The two evaluations run inside the batch-invariant route
(``models/batch_invariant.py``): on the card their sums over the units, as
the task's products, take the port's own kernels, so a row's score does
not depend on how many rows share the call.

Shapes depend on the cohort, so the server pads the cohort axis to a stable
multiple (``pad_count``) with null rows: all-zero data and mask, a strict
training no-op, weight 0 in FedAvg and score 0 in evaluation.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import batch_invariant as bi

Params = Dict[str, torch.Tensor]


def cohort_train(task, params: Params, data: Dict[str, torch.Tensor],
                 mask: torch.Tensor, lr: float, epochs: int,
                 batch_size: int = 50):
    """Train the whole cohort at once.

    task — the ``FeelTask`` whose ``sgd_epoch``/``local_metric`` define
    the per-client step; params — global model (broadcast to every client);
    data — per-sample tensors with leading (N, S), mask (N, S) — the
    padded, stacked cohort.
    Returns (stacked_params with leaves (N, ...), acc_local (N,)) where
    acc_local is each client's self-reported metric on its own (valid)
    samples after local training (Alg. 1 line 11).
    """
    return cohort_train_multi(task, broadcast_params(params, mask.shape[0]),
                              data, mask, lr, epochs, batch_size)


def cohort_train_multi(task, stacked_params: Params,
                       data: Dict[str, torch.Tensor], mask: torch.Tensor,
                       lr: float, epochs: int, batch_size: int = 50):
    """``cohort_train`` with per-client parameters (leaves (N, ...)).

    Rows gathered from different runs (policy x seed x scenario) carry
    different global models, so the run axis folds into the client axis:
    one call trains any mix of runs whose padded (N, S) shapes match. Row
    results are independent of the other rows.
    """
    p = stacked_params
    for _ in range(epochs):
        p = task.sgd_epoch(p, data, mask, lr, batch_size)
    return p, task.local_metric(p, data, mask)


def pad_count(n: int, multiple: int = 8) -> int:
    """Cohort-axis padding target: next power of two below ``multiple``
    (1, 2, 4), multiples of ``multiple`` above — a small set of cohort
    shapes without ballooning small sub-cohorts."""
    if n < 1:
        raise ValueError(f"cohort of {n} clients")
    if n >= multiple:
        return -(-n // multiple) * multiple
    p = 1
    while p < n:
        p *= 2
    return p


def merge_stacks(stacked_list: Sequence[Params],
                 order: Optional[np.ndarray] = None) -> Params:
    """Concatenate per-bucket stacked dicts on axis 0; ``order`` (optional
    int array) then permutes rows — the bucketed engine restores the
    schedule's selection order so FedAvg accumulates in the loop oracle's
    order."""
    merged = (stacked_list[0] if len(stacked_list) == 1 else
              {k: torch.cat([s[k] for s in stacked_list])
               for k in stacked_list[0]})
    if order is not None:
        idx = torch.as_tensor(order, device=next(iter(merged.values())).device)
        merged = {k: v.index_select(0, idx) for k, v in merged.items()}
    return merged


def pad_stacked(stacked: Params, n_total: int) -> Params:
    """Zero-pad a stacked dict's leading axis to ``n_total`` rows (null rows:
    weight 0 in FedAvg, all-zero eval mask)."""
    def pad(l):
        n = l.shape[0]
        if n == n_total:
            return l
        return torch.cat([l, l.new_zeros((n_total - n,) + l.shape[1:])])
    return {k: pad(v) for k, v in stacked.items()}


def broadcast_params(params: Params, n: int) -> Params:
    """Tile a single parameter dict to (n, ...) rows (a view, not a copy)."""
    return {k: v.expand((n,) + v.shape) for k, v in params.items()}


@bi.task_plane
def cohort_eval(task, stacked_params: Params, eval_inputs,
                y_units: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Score every uploaded model on the public test set at once.

    stacked_params — leaves (N, ...); eval_inputs — the task's test tensors;
    y_units (U,) — test labels; masks (N, U) — per-UE evaluation unit masks.
    Returns (N,) unit accuracies, 0.0 where a mask is empty.
    """
    correct = (task.predict_units(stacked_params, eval_inputs)
               == y_units).float()
    return bi.masked_mean(correct, masks, 1)


@bi.task_plane
def cohort_eval_rows(task, stacked_params: Params, eval_inputs,
                     y_rows: torch.Tensor,
                     masks: torch.Tensor) -> torch.Tensor:
    """``cohort_eval`` with per-row unit labels y_rows (N, U): the sweep
    scores the attack success rate (a row's labels relabelled to the
    attack's target over the watch mask) beside the accuracy rows in one
    call."""
    correct = (task.predict_units(stacked_params, eval_inputs)
               == y_rows).float()
    return bi.masked_mean(correct, masks, 1)


def unstack(stacked_params: Params, i: int) -> Params:
    """Extract client ``i``'s parameter dict from the stacked cohort."""
    return {k: v[i] for k, v in stacked_params.items()}
