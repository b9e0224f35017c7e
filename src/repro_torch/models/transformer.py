"""Decoder-only language models (the LM task's ``lm_tiny`` and the zoo's
dense, vlm, ssm, moe and hybrid families): init, full-sequence forward,
the next-token loss (plus the MoE load-balance loss), the masked federated
twins the cohort engine trains with (dense-only, as in the reference), and
serving — prefill into a decode cache and single-token decode.

Parameters are a flat dict under the JAX package's tree paths joined by
"/": ``embed`` (V, d), ``blocks/layers/0/...`` (each leaf with a leading
``n_blocks`` axis), ``final_norm`` (d,), ``lm_head`` (d, V). Every
function also takes a *stacked* cohort: params with a leading client axis
(N, ...) and tokens (N, B, S); the embedding lookup is then a per-client
gather, the products one batched matmul per layer, and losses and
accuracies come back per client, shape (N,).

A decode cache is a flat dict: ``blocks/layers/0/...`` (the stacked layer
caches of ``blocks.py``), ``index`` — the position of the next token, a
host int (the JAX package's is a traced int32; on the host, K4's cache
length is known without a synchronisation) — and, for a ring buffer,
``slot_pos`` (C,) int32. A decode step updates the cache's tensors in
place and returns the cache with ``index`` advanced.

Multi-token prediction and DeepSeek's leading dense ``head_layers`` of
the JAX package come with a later slice of the port (a config that needs
them raises in ``ModelConfig``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.blocks import (scan_blocks, scan_blocks_decode,
                                       stacked_blocks_init, stacked_cache_init)
from repro_torch.models.common import (cross_entropy, dense_init, dtype_of,
                                       embed_init, linear, ones, prefixed,
                                       rms_norm, sgd_step, subtree)


def lm_init(generator: torch.Generator, cfg, device=None):
    """The LM's parameters on ``device`` (default: the generator's), drawn
    from ``generator`` on its own device in a fixed order: embedding,
    blocks (block by block), head."""
    device = generator.device if device is None else torch.device(device)
    dt, d = dtype_of(cfg), cfg.d_model
    embed = embed_init(generator, (cfg.vocab_size, d), dt).to(device)
    blocks = stacked_blocks_init(generator, cfg, device=device)
    return {"embed": embed,
            **prefixed("blocks/", blocks),
            "final_norm": ones((d,), dt, device),
            "lm_head": dense_init(generator, (d, cfg.vocab_size),
                                  dt).to(device)}


def _embed(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (..., S) -> (..., S, d); a stacked table (N, V, d) looks up
    client i's tokens (tokens (N, ..., S)) in its own rows."""
    if embed.dim() == 2:
        return embed[tokens]
    n = embed.shape[0]
    clients = torch.arange(n, device=embed.device)
    return embed[clients.view(n, *([1] * (tokens.dim() - 1))), tokens]


def _forward(cfg, params, tokens, window, return_cache, with_aux=False):
    """(logits, the summed MoE aux loss — 0.0 without a MoE layer or
    ``with_aux`` — and the caches or None)."""
    h = _embed(params["embed"], tokens).to(dtype_of(cfg))
    h, aux, caches = scan_blocks(cfg, subtree(params, "blocks/"), h,
                                 window=window, return_cache=return_cache,
                                 with_aux=with_aux)
    logits = linear(rms_norm(h, params["final_norm"], cfg.norm_eps),
                    params["lm_head"])
    return logits, aux, caches


def lm_forward(cfg, params, tokens, *, window=None, return_cache=False):
    """tokens (B, S) int64 -> logits (B, S, V); stacked: tokens (N, B, S)
    -> (N, B, S, V). With ``return_cache``: (logits, the stacked layer
    caches of the sequence, under ``blocks.py``'s keys). The MoE aux loss
    is left out (``lm_loss_parts`` has it)."""
    logits, _, caches = _forward(cfg, params, tokens, window, return_cache)
    return (logits, caches) if return_cache else logits


def lm_loss_parts(cfg, params, batch):
    """(next-token cross-entropy, the MoE layers' summed load-balance
    loss: a float32 scalar, 0.0 without a MoE layer) — the reference's
    ``metrics["ce"]`` and ``metrics["aux"]``."""
    tokens = batch["tokens"]
    logits, aux, _ = _forward(cfg, params, tokens, cfg.sliding_window, False,
                              with_aux=True)
    ce = cross_entropy(logits[..., :-1, :], tokens[..., 1:],
                       keep=tokens.dim() - 2)
    return ce, aux


def lm_loss(cfg, params, batch):
    """Next-token cross-entropy plus the MoE aux loss (one per client for
    a stacked cohort, whose dense families have no aux loss). The JAX
    package returns (loss, metrics); ``lm_loss_parts`` gives the metrics,
    and the port's loss is the loss alone."""
    ce, aux = lm_loss_parts(cfg, params, batch)
    return ce + aux


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


# ---------------------------------------------------------------------- #
# Serving
# ---------------------------------------------------------------------- #
def decode_cache_len(cfg, seq_len: int):
    """(cache_len, is_ring). A ring cache of the window serves the
    sliding-window archs, and the long-context variant of the
    full-attention archs past 32,768 tokens."""
    win = cfg.sliding_window
    if (seq_len > 32_768 and cfg.long_context_window
            and cfg.attn_layer_period == 0):
        win = (min(win, cfg.long_context_window) if win
               else cfg.long_context_window)
    if win and win < seq_len:
        return win, True
    return seq_len, False


def lm_cache_init(cfg, batch: int, seq_len: int, device):
    """A zero decode cache for ``seq_len`` positions, index 0."""
    cache_len, ring = decode_cache_len(cfg, seq_len)
    cache = {**prefixed("blocks/", stacked_cache_init(cfg, batch, cache_len,
                                                       device)),
             "index": 0}
    if ring:
        cache["slot_pos"] = torch.full((cache_len,), -1, dtype=torch.int32,
                                       device=device)
    return cache


def lm_prefill(cfg, params, tokens, target_len: Optional[int] = None):
    """Prefill: tokens (B, S) -> (last-position logits (B, V), a decode
    cache of the S positions, grown to ``target_len`` when it is
    longer)."""
    s = tokens.shape[1]
    logits, _, caches = _forward(cfg, params, tokens, cfg.sliding_window,
                                 True)
    cache = {**prefixed("blocks/", caches), "index": s}
    if target_len is not None and target_len > s:
        cache = grow_cache(cache, target_len - s)
    return logits[:, -1], cache


def grow_cache(cache, extra: int):
    """The cache with its attention k/v padded by ``extra`` zero positions
    (their position axis, -3); every other leaf as it is."""
    return {key: (F.pad(x, (0, 0, 0, 0, 0, extra))
                  if key.rsplit("/", 1)[-1] in ("k", "v") else x)
            for key, x in cache.items()}


def lm_decode_step(cfg, params, cache, token):
    """token (B, 1) -> (logits (B, V), the cache advanced by one position;
    its tensors are updated in place)."""
    index = cache["index"]
    slot_pos = cache.get("slot_pos")
    window = cfg.sliding_window if slot_pos is None else None
    h = _embed(params["embed"], token).to(dtype_of(cfg))
    h, blocks = scan_blocks_decode(cfg, subtree(params, "blocks/"), h,
                                   subtree(cache, "blocks/"), index,
                                   slot_pos=slot_pos, window=window)
    hn = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = linear(hn[:, 0], params["lm_head"])
    new_cache = {**prefixed("blocks/", blocks), "index": index + 1}
    if slot_pos is not None:
        new_cache["slot_pos"] = slot_pos
    return logits, new_cache
