"""The model/data pair the FEEL round trains: ``MnistTask``, the paper's §V
protocol (2-layer MLP on synthetic MNIST).

The server orchestrates Alg. 1 over the task's methods:

    data plane   — generate_data / partition_clients / histogram / gini: the
        dataset, the group-based non-IID allocation and the metadata a UE
        reports (its class histogram).
    device plane — init_params / sgd_epoch / local_metric / predict_units,
        on a stacked cohort (leading client axis, see ``models.mlp``).
        Zero-padded rows with mask 0 contribute exactly zero gradient.
    eval units   — MNIST units are test samples; per-UE support masks (Eq.
        1's class-restricted acc_test) come from each UE's histogram.
    loop oracle  — local_train / eval_units_loop / global_metrics: the
        sequential per-client path (``engine="loop"``).

The LM task of the JAX package (``lm_tiny``) arrives with the LM slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.diversity import gini_simpson
from repro_torch.data.partition import (GROUP_SIZE, MAX_GROUPS, MIN_GROUPS,
                                        label_histogram, partition)
from repro_torch.data.synthetic_mnist import N_CLASSES, generate
from repro_torch.federated.client import ClientReport, local_train
from repro_torch.models.mlp import (mlp_accuracy, mlp_accuracy_masked,
                                    mlp_apply, mlp_init,
                                    mlp_sgd_epoch_masked)


@dataclasses.dataclass(frozen=True)
class MnistTask:
    """The paper's §V protocol: 2-layer MLP on synthetic MNIST."""
    name: str = "mnist_mlp"
    n_symbols: int = N_CLASSES
    group_size: int = GROUP_SIZE
    min_groups: int = MIN_GROUPS
    max_groups: int = MAX_GROUPS
    batch_size: int = 50
    default_lr: float = 0.1
    default_n_train: int = 50_000
    default_n_test: int = 10_000

    # -- host/data plane ------------------------------------------------ #
    def generate_data(self, n_train: int, n_test: int, seed: int):
        return generate(n_train, n_test, seed=seed)

    def partition_clients(self, train, n_ues, rng, malicious=None,
                          attack=None, context=""):
        return partition(train, n_ues, rng, malicious, attack,
                         group_size=self.group_size,
                         min_groups=self.min_groups,
                         max_groups=self.max_groups,
                         context=context or f"task={self.name}")

    def histogram(self, data) -> np.ndarray:
        """What a UE reports: its label histogram (claimed class support)."""
        return label_histogram(data, self.n_symbols)

    def gini(self, data) -> float:
        """Eq. 2 elements diversity: Gini-Simpson over label frequencies."""
        return gini_simpson(data.y, self.n_symbols)

    # -- eval units ------------------------------------------------------ #
    def unit_labels(self, test) -> np.ndarray:
        return np.asarray(test.y)

    def unit_rows(self, test) -> np.ndarray:
        """The test row each unit comes from (the validation split is the
        units of the first ``n_val`` rows)."""
        return np.arange(len(test.y))

    def eval_inputs(self, test, device):
        return {"x": torch.as_tensor(test.x, device=device)}

    def unit_targets(self, test, device) -> torch.Tensor:
        return torch.as_tensor(test.y, device=device).long()

    # -- device plane (stacked cohort) ------------------------------------ #
    def init_params(self, generator: torch.Generator, device):
        return mlp_init(generator, device=device)

    def sgd_epoch(self, params, d, m, lr, batch_size: int):
        return mlp_sgd_epoch_masked(params, d["x"], d["y"], m, lr,
                                    batch_size)

    def local_metric(self, params, d, m):
        return mlp_accuracy_masked(params, d["x"], d["y"], m)

    def predict_units(self, params, ei) -> torch.Tensor:
        return torch.argmax(mlp_apply(params, ei["x"]), -1)

    # -- loop oracle ----------------------------------------------------- #
    def local_train(self, client, global_params, epochs: int, lr: float,
                    batch_size: int) -> ClientReport:
        return local_train(client, global_params, epochs, lr,
                           batch_size=batch_size)

    def eval_units_loop(self, params, test, m: np.ndarray) -> float:
        if not m.any():
            return 0.0
        device = params["w1"].device
        return float(mlp_accuracy(
            params, torch.as_tensor(test.x[m], device=device),
            torch.as_tensor(test.y[m], device=device).long()))

    def global_metrics(self, params, test, ei, ey, watch_class,
                       watch_target):
        """(global_acc, global_loss, source_acc, attack_success)."""
        g_acc = float(mlp_accuracy(params, ei["x"], ey))
        src_acc = atk_succ = float("nan")
        if watch_class is not None:
            m = test.y == watch_class
            if m.any():
                xs = torch.as_tensor(test.x[m], device=ey.device)
                src_acc = float(mlp_accuracy(
                    params, xs, torch.as_tensor(test.y[m],
                                                device=ey.device).long()))
                if watch_target is not None:
                    tgt = torch.full((int(m.sum()),), watch_target,
                                     dtype=ey.dtype, device=ey.device)
                    atk_succ = float(mlp_accuracy(params, xs, tgt))
        return g_acc, float("nan"), src_acc, atk_succ


def as_task(spec) -> MnistTask:
    """A task spec: a ``MnistTask`` (pass-through) or its registry name."""
    if isinstance(spec, MnistTask):
        return spec
    if spec == "mnist_mlp":
        return MnistTask()
    if spec == "lm_tiny":
        raise NotImplementedError("the lm_tiny task is ported with the LM "
                                  "slice")
    raise KeyError(f"unknown task {spec!r}")
