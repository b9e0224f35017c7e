"""The paper's experimental model: a two-fully-connected-layer MLP for
(synthetic) MNIST, trained with FedAvg (Section V: "simple multi-layer
perceptron (MLP) model with two fully connected layers").

Parameters are a dict of tensors in the JAX package's layout and key set:
``w1`` (784, 64), ``b1`` (64,), ``w2`` (64, 10), ``b2`` (10,) — weights
stored (in, out). Every function also takes a *stacked* cohort: params
with a leading client axis (N, ...) and data with the same leading axis,
(N, B, 784). The products are then batched matmuls, one per client, and
losses come back per client, shape (N,).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import batch_invariant as bi
from repro_torch.models.common import dense_init, sgd_step
from repro_torch.random import split

Params = Dict[str, torch.Tensor]


def mlp_init(key: torch.Tensor, n_in: int = 28 * 28,
             n_hidden: int = 64, n_out: int = 10, dtype=torch.float32,
             device: DeviceLike = None) -> Params:
    """The reference's ``mlp_init`` from ``key`` (``random.PRNGKey``),
    drawn on ``device`` (None: the GPU, which raises without CUDA before
    any draw)."""
    device = resolve_device(device)
    k1, k2 = split(key.to(device))
    return {
        "w1": dense_init(k1, (n_in, n_hidden), dtype),
        "b1": torch.zeros((n_hidden,), dtype=dtype, device=device),
        "w2": dense_init(k2, (n_hidden, n_out), dtype),
        "b2": torch.zeros((n_out,), dtype=dtype, device=device),
    }


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (..., B, 784) -> logits (..., B, 10); in the task plane on the
    card through the batch-invariant kernels (``models/batch_invariant.py``).
    """
    if bi.on(x):
        h = torch.relu(bi.affine(x, params["w1"], params["b1"]))
        return bi.affine(h, params["w2"], params["b2"])
    h = torch.relu(x @ params["w1"] + params["b1"].unsqueeze(-2))
    return h @ params["w2"] + params["b2"].unsqueeze(-2)


def _nll(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample cross-entropy (..., B); ``y`` int64."""
    logits = mlp_apply(params, x)
    if bi.on(logits):
        return bi.nll(logits, y)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y.unsqueeze(-1)).squeeze(-1)
    return logz - ll


def mlp_loss(params: Params, batch) -> torch.Tensor:
    nll = _nll(params, batch["x"], batch["y"])
    return bi.mean(nll, nll.dim() - 1)


def mlp_accuracy(params: Params, x, y) -> torch.Tensor:
    correct = (bi.argmax(mlp_apply(params, x)) == y).float()
    return bi.mean(correct, correct.dim() - 1)


def mlp_sgd_epoch(params: Params, x, y, lr: float,
                  batch_size: int = 50) -> Params:
    """One epoch of mini-batch SGD over a client dataset (the loop oracle's
    epoch); a tail batch shorter than ``batch_size`` is dropped."""
    n = x.shape[-2]
    nb = max(n // batch_size, 1)
    for i in range(nb):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        params = sgd_step(
            params, lambda p, sl=sl: mlp_loss(p, {"x": x[..., sl, :],
                                                  "y": y[..., sl]}), lr)
    return params


# ---------------------------------------------------------------------- #
# Masked variants — the vectorized cohort engine's contract: client
# datasets are zero-padded to a uniform length with a {0,1} validity mask;
# a padded sample contributes *exactly* zero gradient, so the padded run
# reproduces the unpadded one, and a fully padded batch is a strict no-op
# (zero gradient -> params unchanged bit for bit).
# ---------------------------------------------------------------------- #
def mlp_loss_masked(params: Params, batch) -> torch.Tensor:
    """Mean cross-entropy over the valid samples of a batch.

    batch["m"] (..., B) float validity mask; padding rows carry m == 0.
    """
    m = batch["m"]
    nll = _nll(params, batch["x"], batch["y"])
    return bi.masked_mean(nll, m, nll.dim() - 1)


def mlp_accuracy_masked(params: Params, x, y, m) -> torch.Tensor:
    """Accuracy over the valid samples only (0.0 when the mask is empty)."""
    correct = (bi.argmax(mlp_apply(params, x)) == y).float()
    return bi.masked_mean(correct, m, correct.dim() - 1)


def mlp_sgd_epoch_masked(params: Params, x, y, m, lr: float,
                         batch_size: int = 50) -> Params:
    """Masked twin of ``mlp_sgd_epoch`` over a padded client dataset.

    x (..., S, D), y (..., S), m (..., S) with S a multiple of batch_size;
    batch i covers the same rows the plain epoch slices, and batches that
    fall entirely in the padding leave params untouched.
    """
    n = x.shape[-2]
    if n % batch_size:
        raise ValueError(
            f"padded length {n} must be a multiple of batch_size "
            f"{batch_size} (pad_clients(multiple_of=batch_size) "
            "guarantees this)")
    for i in range(n // batch_size):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        batch = {"x": x[..., sl, :], "y": y[..., sl], "m": m[..., sl]}
        params = sgd_step(
            params, lambda p, b=batch: mlp_loss_masked(p, b), lr)
    return params
