"""The model/data pair the FEEL round trains, a sweep axis of the JAX
package: ``MnistTask`` (``mnist_mlp``), the paper's §V protocol (2-layer
MLP on synthetic MNIST), and ``LmTask`` (``lm_tiny``), federated
fine-tuning of a 2-layer decoder-only transformer on synthetic
domain-skewed token windows.

The server orchestrates Alg. 1 over the task's methods:

    data plane   — generate_data / partition_clients / histogram / gini: the
        dataset, the group-based non-IID allocation and the metadata a UE
        reports (its class histogram).
    device plane — init_params / sgd_epoch / local_metric / predict_units,
        on a stacked cohort (leading client axis, see ``models.mlp``).
        Zero-padded rows with mask 0 contribute exactly zero gradient.
    eval units   — MNIST units are test samples, LM units the ``W x
        (seq-1)`` next-token target positions of the held-out windows;
        per-UE support masks (Eq. 1's class-restricted acc_test) come from
        each UE's label or token histogram.
    loop oracle  — local_train / eval_units_loop / global_metrics: the
        sequential per-client path (``engine="loop"``).

The device plane and the loop oracle run inside the batch-invariant route
(``models/batch_invariant.py``, ``bi.task_plane``): on the card their
float32 products and sums go to the port's own kernels, so a client's
result does not depend on how many clients share a call and the two
engines agree bit for bit there too.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.diversity import gini_simpson, gini_simpson_hist
from repro_torch.data.partition import (GROUP_SIZE, MAX_GROUPS, MIN_GROUPS,
                                        label_histogram, partition)
from repro_torch.data.synthetic_mnist import N_CLASSES, generate
from repro_torch.data.tokens import make_windows
from repro_torch.federated.client import ClientReport, local_train
from repro_torch.models import batch_invariant as bi
from repro_torch.models.mlp import (mlp_accuracy, mlp_accuracy_masked,
                                    mlp_apply, mlp_init,
                                    mlp_sgd_epoch_masked)
from repro_torch.models.transformer import (lm_accuracy_masked, lm_forward,
                                            lm_init, lm_loss, lm_sgd_epoch,
                                            lm_sgd_epoch_masked)


class FeelTask:
    """What every task implements (see the module docstring). Tasks are
    frozen dataclasses: hashable and comparable, as in the JAX package.

    Host/data plane:  generate_data, partition_clients, histogram, gini.
    Eval units:       unit_labels, unit_rows, eval_inputs, unit_targets.
    Device plane:     init_params, sgd_epoch, local_metric, predict_units.
    Loop oracle:      local_train, eval_units_loop, global_metrics.
    Protocol knobs:   group_size/min_groups/max_groups (partition),
                      batch_size, default_lr, default_n_train/_n_test.
    """

    name: str


@dataclasses.dataclass(frozen=True)
class MnistTask(FeelTask):
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
    def init_params(self, key: torch.Tensor, device):
        return mlp_init(key, device=device)

    @bi.task_plane
    def sgd_epoch(self, params, d, m, lr, batch_size: int):
        return mlp_sgd_epoch_masked(params, d["x"], d["y"], m, lr,
                                    batch_size)

    @bi.task_plane
    def local_metric(self, params, d, m):
        return mlp_accuracy_masked(params, d["x"], d["y"], m)

    @bi.task_plane
    def predict_units(self, params, ei) -> torch.Tensor:
        return bi.argmax(mlp_apply(params, ei["x"]))

    @bi.task_plane
    def eval_loss(self, params, ei):
        return None          # accuracy is the task's only global metric

    # -- loop oracle ----------------------------------------------------- #
    @bi.task_plane
    def local_train(self, client, global_params, epochs: int, lr: float,
                    batch_size: int) -> ClientReport:
        return local_train(client, global_params, epochs, lr,
                           batch_size=batch_size)

    @bi.task_plane
    def eval_units_loop(self, params, test, m: np.ndarray) -> float:
        if not m.any():
            return 0.0
        device = params["w1"].device
        return float(mlp_accuracy(
            params, torch.as_tensor(test.x[m], device=device),
            torch.as_tensor(test.y[m], device=device).long()))

    @bi.task_plane
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


# 2-layer decoder-only transformer, small enough that a federated run takes
# seconds, large enough to learn the Zipf-Markov bigram structure
LM_TINY = ModelConfig(name="lm-tiny", family="dense", n_layers=2,
                      d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                      vocab_size=64, dtype="float32")


def _lm_predict(cfg, params, tokens: torch.Tensor) -> torch.Tensor:
    """(..., W, S) tokens -> (..., W*(S-1)) greedy next-token predictions
    (the eval units)."""
    logits = lm_forward(cfg, params, tokens, window=cfg.sliding_window)
    pred = bi.argmax(logits[..., :-1, :])
    return pred.reshape(*pred.shape[:-2], -1)


@dataclasses.dataclass(frozen=True)
class LmTask(FeelTask):
    """Federated LM fine-tuning on synthetic domain-skewed token windows.

    Clients hold ``(n, seq)`` int32 windows cut from per-domain Zipf-Markov
    streams (``data/tokens.py::make_windows``); the window's domain id is
    the partition sort key (the non-IID role MNIST labels play), while the
    quality metadata the server sees — histogram, Gini-Simpson diversity,
    eval support masks — is computed over the TOKENS the model learns.
    Evaluation units are the held-out windows' next-token target
    positions; the held-out per-token cross-entropy is the global loss
    (``RoundLog.global_loss``).
    """
    name: str = "lm_tiny"
    model: ModelConfig = LM_TINY
    seq: int = 32
    n_domains: int = 10
    group_size: int = 16
    min_groups: int = 1
    max_groups: int = 8
    batch_size: int = 8
    default_lr: float = 0.3
    default_n_train: int = 2_000
    default_n_test: int = 400

    @property
    def n_symbols(self) -> int:
        return self.model.vocab_size

    # -- host/data plane ------------------------------------------------ #
    def generate_data(self, n_train: int, n_test: int, seed: int):
        ds = make_windows(n_train + n_test, self.model.vocab_size, self.seq,
                          n_domains=self.n_domains, seed=seed)
        idx = np.arange(n_train + n_test)
        # windows are domain-interleaved, so a head/tail split keeps both
        # sides domain-balanced
        return ds.subset(idx[:n_train]), ds.subset(idx[n_train:])

    def partition_clients(self, train, n_ues, rng, malicious=None,
                          attack=None, context=""):
        return partition(train, n_ues, rng, malicious, attack,
                         group_size=self.group_size,
                         min_groups=self.min_groups,
                         max_groups=self.max_groups,
                         context=context or f"task={self.name}")

    def histogram(self, data) -> np.ndarray:
        """What a UE reports: its token histogram (claimed vocab support)."""
        return np.bincount(data.tokens.reshape(-1).astype(int),
                           minlength=self.model.vocab_size)

    def gini(self, data) -> float:
        """Eq. 2 elements diversity: Gini-Simpson over token frequencies."""
        return gini_simpson_hist(self.histogram(data))

    # -- eval units ------------------------------------------------------ #
    def unit_labels(self, test) -> np.ndarray:
        return np.asarray(test.tokens[:, 1:]).reshape(-1)

    def unit_rows(self, test) -> np.ndarray:
        return np.repeat(np.arange(len(test)), self.seq - 1)

    def eval_inputs(self, test, device):
        return {"tokens": torch.as_tensor(test.tokens, device=device).long()}

    def unit_targets(self, test, device) -> torch.Tensor:
        return torch.as_tensor(test.tokens[:, 1:].reshape(-1),
                               device=device).long()

    # -- device plane (stacked cohort) ------------------------------------ #
    def init_params(self, key: torch.Tensor, device):
        return lm_init(key, self.model, device=device)

    @bi.task_plane
    def sgd_epoch(self, params, d, m, lr, batch_size: int):
        return lm_sgd_epoch_masked(self.model, params, d["tokens"], m, lr,
                                   batch_size)

    @bi.task_plane
    def local_metric(self, params, d, m):
        return lm_accuracy_masked(self.model, params, d["tokens"], m)

    @bi.task_plane
    def predict_units(self, params, ei) -> torch.Tensor:
        """Stacked params (N, ...) -> (N, U) predictions on the shared
        held-out windows."""
        n = params["embed"].shape[0]
        tokens = ei["tokens"]
        return _lm_predict(self.model, params,
                           tokens.expand(n, *tokens.shape))

    @bi.task_plane
    def eval_loss(self, params, ei) -> torch.Tensor:
        """Held-out per-token cross-entropy (the LM quality metric)."""
        return lm_loss(self.model, params, {"tokens": ei["tokens"]})

    # -- loop oracle ----------------------------------------------------- #
    @bi.task_plane
    def local_train(self, client, global_params, epochs: int, lr: float,
                    batch_size: int) -> ClientReport:
        device = global_params["embed"].device
        tokens = torch.as_tensor(client.data.tokens, device=device).long()
        params = global_params
        for _ in range(epochs):
            params = lm_sgd_epoch(self.model, params, tokens, lr,
                                  batch_size)
        m = torch.ones(tokens.shape[0], device=device)
        acc = float(lm_accuracy_masked(self.model, params, tokens, m))
        return ClientReport(ue_id=client.ue_id, params=params,
                            acc_local=acc, n_samples=client.size)

    @bi.task_plane
    def eval_units_loop(self, params, test, m: np.ndarray) -> float:
        if not m.any():
            return 0.0
        tokens = torch.as_tensor(test.tokens,
                                 device=params["embed"].device).long()
        pred = _lm_predict(self.model, params, tokens).cpu().numpy()
        return _f32_masked_acc(pred == self.unit_labels(test), m)

    @bi.task_plane
    def global_metrics(self, params, test, ei, ey, watch_class,
                       watch_target):
        """(global_acc, global_loss, source_acc, attack_success) — unit
        accuracy and held-out per-token CE; the watched pair is a (source,
        target) TOKEN pair (``core.attacks.TokenFlip``)."""
        pred = _lm_predict(self.model, params, ei["tokens"]).cpu().numpy()
        labels = self.unit_labels(test)
        g_acc = _f32_masked_acc(pred == labels, np.ones(labels.size, bool))
        g_loss = float(self.eval_loss(params, ei))
        src_acc = atk_succ = float("nan")
        if watch_class is not None:
            m = labels == watch_class
            if m.any():
                src_acc = _f32_masked_acc(pred == watch_class, m)
                if watch_target is not None:
                    atk_succ = _f32_masked_acc(pred == watch_target, m)
        return g_acc, g_loss, src_acc, atk_succ


def _f32_masked_acc(correct: np.ndarray, m: np.ndarray) -> float:
    """Masked accuracy in ``cohort.cohort_eval``'s float32 arithmetic
    (exact integer sums, one float32 division), so the loop engine's Eq. 1
    inputs equal the vectorized engine's bit for bit."""
    num = np.float32((correct & m).sum())
    den = np.maximum(np.float32(m.sum()), np.float32(1.0))
    return float(num / den)


TASKS = {t.name: t for t in (MnistTask(), LmTask())}


def as_task(spec) -> FeelTask:
    """A task spec: a ``FeelTask`` (pass-through) or its registry name."""
    if isinstance(spec, FeelTask):
        return spec
    if isinstance(spec, str):
        try:
            return TASKS[spec]
        except KeyError:
            raise KeyError(f"unknown task {spec!r}; registered: "
                           f"{sorted(TASKS)}") from None
    raise TypeError(f"task spec must be a FeelTask or registry name, got "
                    f"{type(spec).__name__}")
