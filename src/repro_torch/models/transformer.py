"""The decoder-only language model of the LM task (dense family): init,
full-sequence forward, the next-token loss, and the masked federated twins
the cohort engine trains with.

Parameters are a flat dict under the JAX package's tree paths joined by
"/": ``embed`` (V, d), ``blocks/layers/0/...`` (each leaf with a leading
``n_blocks`` axis), ``final_norm`` (d,), ``lm_head`` (d, V). Every
function also takes a *stacked* cohort: params with a leading client axis
(N, ...) and tokens (N, B, S); the embedding lookup is then a per-client
gather, the products one batched matmul per layer, and losses and
accuracies come back per client, shape (N,).

The MoE router loss, multi-token prediction, decode caches and prefill of
the JAX package belong to the big-model zoo and are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.models.blocks import scan_blocks, stacked_blocks_init
from repro_torch.models.common import (cross_entropy, dense_init, dtype_of,
                                       embed_init, linear, ones, prefixed,
                                       rms_norm, sgd_step, subtree)


def lm_init(generator: torch.Generator, cfg, device="cpu"):
    dt, d = dtype_of(cfg), cfg.d_model
    params = {"embed": embed_init(generator, (cfg.vocab_size, d), dt),
              **prefixed("blocks/", stacked_blocks_init(generator, cfg)),
              "final_norm": ones((d,), dt),
              "lm_head": dense_init(generator, (d, cfg.vocab_size), dt)}
    return {k: v.to(device) for k, v in params.items()}


def _embed(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (..., S) -> (..., S, d); a stacked table (N, V, d) looks up
    client i's tokens (tokens (N, ..., S)) in its own rows."""
    if embed.dim() == 2:
        return embed[tokens]
    n = embed.shape[0]
    clients = torch.arange(n, device=embed.device)
    return embed[clients.view(n, *([1] * (tokens.dim() - 1))), tokens]


def lm_forward(cfg, params, tokens, *, window=None):
    """tokens (B, S) int64 -> logits (B, S, V); stacked: tokens (N, B, S)
    -> (N, B, S, V)."""
    h = _embed(params["embed"], tokens).to(dtype_of(cfg))
    h = scan_blocks(cfg, subtree(params, "blocks/"), h, window=window)
    return linear(rms_norm(h, params["final_norm"], cfg.norm_eps),
                  params["lm_head"])


def lm_loss(cfg, params, batch):
    """Next-token cross-entropy (one per client for a stacked cohort). The
    JAX package returns (loss, metrics); the dense family's only metric is
    the loss itself, so the port returns the loss."""
    tokens = batch["tokens"]
    logits = lm_forward(cfg, params, tokens, window=cfg.sliding_window)
    return cross_entropy(logits[..., :-1, :], tokens[..., 1:],
                         keep=tokens.dim() - 2)


# ---------------------------------------------------------------------- #
# Masked federated twins — the cohort engine's contract (models/mlp.py has
# the feature-model originals): client datasets are zero-padded to a
# uniform window count with a {0,1} per-window validity mask; a padded
# window contributes *exactly* zero loss and gradient, so the padded run
# reproduces the unpadded one. The window mask expands to per-token target
# weights (a target position counts iff both it and its input position are
# valid).
# ---------------------------------------------------------------------- #
def _token_weights(tokens: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., B) per-window or (..., B, S) per-token validity -> (..., B,
    S-1) next-token target weights."""
    m = m.to(torch.float32)
    if m.dim() == tokens.dim() - 1:
        m = m.unsqueeze(-1).expand(tokens.shape)
    return m[..., 1:] * m[..., :-1]


def lm_loss_masked(cfg, params, batch):
    """Masked next-token cross-entropy over the valid target positions of
    a batch; batch["tokens"] (..., B, S), batch["m"] (..., B) or (..., B,
    S). Padded positions weigh 0: the loss does not depend on their
    content and their gradient is exactly zero (a fully padded batch
    leaves the params unchanged bit for bit)."""
    tokens = batch["tokens"]
    logits = lm_forward(cfg, params, tokens, window=cfg.sliding_window)
    w = _token_weights(tokens, batch["m"])
    return cross_entropy(logits[..., :-1, :], tokens[..., 1:], mask=w,
                         keep=tokens.dim() - 2)


def lm_accuracy_masked(cfg, params, tokens, m):
    """Masked greedy next-token accuracy (Alg. 1 line 11's local metric);
    0.0 on an empty mask."""
    logits = lm_forward(cfg, params, tokens, window=cfg.sliding_window)
    correct = (torch.argmax(logits[..., :-1, :], -1)
               == tokens[..., 1:]).float()
    w = _token_weights(tokens, m)
    return (correct * w).sum((-2, -1)) / w.sum((-2, -1)).clamp_min(1.0)


def lm_sgd_epoch(cfg, params, tokens, lr: float, batch_size: int = 8):
    """One epoch of mini-batch SGD over a client's windows (the loop
    oracle's epoch); a tail batch shorter than ``batch_size`` is
    dropped."""
    n = tokens.shape[-2]
    for i in range(max(n // batch_size, 1)):
        tb = tokens[..., i * batch_size:(i + 1) * batch_size, :]
        params = sgd_step(
            params, lambda p, tb=tb: lm_loss(cfg, p, {"tokens": tb}), lr)
    return params


def lm_sgd_epoch_masked(cfg, params, tokens, m, lr: float,
                        batch_size: int = 8):
    """Masked twin of ``lm_sgd_epoch`` over a padded window set.

    tokens (..., n, S), m (..., n) with n a multiple of batch_size; batch i
    is rows [i·batch_size, (i+1)·batch_size), the JAX package's row-major
    (nb, batch, seq) grid, and batches that fall entirely in the padding
    leave params untouched.
    """
    n = tokens.shape[-2]
    if n % batch_size:
        raise ValueError(
            f"padded window count {n} must be a multiple of batch_size "
            f"{batch_size} (pad_clients(multiple_of=batch_size) "
            "guarantees this)")
    for i in range(n // batch_size):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        batch = {"tokens": tokens[..., sl, :], "m": m[..., sl]}
        params = sgd_step(
            params, lambda p, b=batch: lm_loss_masked(cfg, p, b), lr)
    return params
