"""Federated client: local training on the UE's (possibly poisoned) dataset
and the self-reported local accuracy of Alg. 1 line 11 — the loop oracle
the vectorized cohort engine is held against.

A malicious UE does not lie about the number it reports: it truthfully
evaluates on its own poisoned data, which is why Eq. 1 uses the
server-side test-set gap to catch it."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.data.partition import ClientData
from repro_torch.models.mlp import mlp_accuracy, mlp_sgd_epoch


@dataclasses.dataclass
class ClientReport:
    ue_id: int
    params: dict
    acc_local: float
    n_samples: int


def local_train(client: ClientData, global_params, epochs: int,
                lr: float = 0.1, batch_size: int = 50) -> ClientReport:
    device = global_params["w1"].device
    x = torch.as_tensor(client.data.x, device=device)
    y = torch.as_tensor(client.data.y, device=device).long()
    params = global_params
    for _ in range(epochs):
        params = mlp_sgd_epoch(params, x, y, lr, batch_size)
    acc = float(mlp_accuracy(params, x, y))
    return ClientReport(ue_id=client.ue_id, params=params,
                        acc_local=acc, n_samples=client.size)
