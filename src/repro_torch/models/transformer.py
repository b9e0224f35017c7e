"""Decoder-only language models (the LM task's ``lm_tiny`` and the zoo's
dense, vlm, ssm, moe and hybrid families): init, full-sequence forward,
the next-token loss (plus the MoE load-balance loss and DeepSeek's
multi-token-prediction loss), the masked federated twins the cohort
engine trains with (dense-only, as in the reference), and serving —
prefill into a decode cache and single-token decode.

Parameters are a flat dict under the JAX package's tree paths joined by
"/": ``embed`` (V, d), ``blocks/layers/0/...`` (each leaf with a leading
``n_blocks`` axis), ``final_norm`` (d,), ``lm_head`` (d, V); with
``first_dense_layers``, DeepSeek's unrolled attention + SwiGLU layers
``head_layers/<i>/...`` run before the blocks; with ``mtp``, the depth-1
multi-token-prediction head ``mtp/{proj,norm_h,norm_e,layer/...}``, which
only the loss runs. Every function also takes a *stacked* cohort of the
dense families: params with a leading client axis (N, ...) and tokens (N,
B, S); the embedding lookup is then a per-client gather, the products one
batched matmul per layer, and losses and accuracies come back per client,
shape (N,).

A decode cache is a flat dict: ``blocks/layers/0/...`` (the stacked layer
caches of ``blocks.py``), ``head_layers/<i>/...`` (the leading dense
layers' caches), ``index`` — the position of the next token, a host int
(the JAX package's is a traced int32; on the host, K4's cache length is
known without a synchronisation) — and, for a ring buffer, ``slot_pos``
(C,) int32. A decode step updates the cache's tensors in place and
returns the cache with ``index`` advanced.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import batch_invariant as bi
from repro_torch.models.blocks import (layer_apply, layer_cache_init,
                                       layer_decode, layer_init, scan_blocks,
                                       scan_blocks_decode,
                                       stacked_blocks_init, stacked_cache_init)
from repro_torch.models.common import (cross_entropy, dense_init, dtype_of,
                                       embed_init, linear, ones, prefixed,
                                       rms_norm, sgd_step, subtree)
from repro_torch.random import split
from repro_torch.sharding.ctx import constrain
from repro_torch.sharding.dtensor import embed_lookup, zero_pad


HEAD_KIND = {"mixer": "attn", "mlp": "dense"}   # a leading dense layer's


def lm_init(key: torch.Tensor, cfg, device=None):
    """The reference's ``lm_init`` from ``key``, drawn on ``device``
    (default: the key's): embedding, blocks (block by block), head, the
    leading dense layers, the MTP head, each from the reference's
    subkey."""
    if device is not None:
        key = key.to(device)
    ks = split(key, 8)
    dt, d, dev = dtype_of(cfg), cfg.d_model, key.device
    params = {"embed": embed_init(ks[0], (cfg.vocab_size, d), dt)}
    params.update(prefixed("blocks/", stacked_blocks_init(ks[1], cfg)))
    params["final_norm"] = ones((d,), dt, dev)
    params["lm_head"] = dense_init(ks[2], (d, cfg.vocab_size), dt)
    if cfg.first_dense_layers:
        hks = split(ks[3], cfg.first_dense_layers)
        for i in range(cfg.first_dense_layers):
            params.update(prefixed(f"head_layers/{i}/", layer_init(
                hks[i], cfg, HEAD_KIND)))
    if cfg.mtp:
        mtp = {"proj": dense_init(ks[4], (2 * d, d), dt, fan_in=2 * d),
               "norm_h": ones((d,), dt, dev),
               "norm_e": ones((d,), dt, dev),
               **prefixed("layer/", layer_init(ks[5], cfg, HEAD_KIND))}
        params.update(prefixed("mtp/", mtp))
    return params


def _embed(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (..., S) -> (..., S, d); a stacked table (N, V, d) looks up
    client i's tokens (tokens (N, ..., S)) in its own rows. A ``DTensor``
    table (a sharded step) is read on each rank's shards
    (``sharding.dtensor.embed_lookup``). In the task plane on the card
    its gradient is a one-hot product on the batch-invariant kernel
    (``models/batch_invariant.py``), where autograd would accumulate with
    ``index_put``."""
    if bi.on(embed):
        return bi.embed(embed, tokens)
    if embed.dim() == 2:
        return embed_lookup(embed, tokens)
    n = embed.shape[0]
    clients = torch.arange(n, device=embed.device)
    return embed[clients.view(n, *([1] * (tokens.dim() - 1))), tokens]


def _forward(cfg, params, tokens, window, return_cache, with_aux=False,
             remat=False):
    """(logits, the summed MoE aux loss — 0.0 without a MoE layer or
    ``with_aux`` —, the caches under their cache keys or None, and the
    last hidden state before the final norm). ``remat`` rematerialises
    the stacked blocks in the backward (``scan_blocks``); the leading
    dense layers are unrolled outside the scan, as in the reference."""
    h = constrain(_embed(params["embed"], tokens).to(dtype_of(cfg)), "act")
    aux, caches = 0.0, {}
    for i in range(cfg.first_dense_layers):
        h, a, c = layer_apply(cfg, subtree(params, f"head_layers/{i}/"),
                              HEAD_KIND, h, window=window, with_aux=with_aux)
        aux = aux + a
        caches.update(prefixed(f"head_layers/{i}/", c))
    h, a, blocks = scan_blocks(cfg, subtree(params, "blocks/"), h,
                               window=window, return_cache=return_cache,
                               with_aux=with_aux, remat=remat)
    aux = aux + a
    logits = constrain(linear(rms_norm(h, params["final_norm"], cfg.norm_eps),
                              params["lm_head"]), "logits")
    if not return_cache:
        return logits, aux, None, h
    return logits, aux, {**caches, **prefixed("blocks/", blocks)}, h


def lm_forward(cfg, params, tokens, *, window=None, return_cache=False,
               remat=False):
    """tokens (B, S) int64 -> logits (B, S, V); stacked: tokens (N, B, S)
    -> (N, B, S, V). With ``return_cache``: (logits, the layer caches of
    the sequence, under a decode cache's keys). The MoE aux loss is left
    out (``lm_loss_metrics`` has it). ``remat``: see ``_forward``."""
    logits, _, caches, _ = _forward(cfg, params, tokens, window,
                                    return_cache, remat=remat)
    return (logits, caches) if return_cache else logits


def _mtp_ce(cfg, params, tokens, h, window):
    """The depth-1 MTP loss: the running hidden state combined with the
    embedding of the *next* token, one more attention + SwiGLU layer, and
    the cross-entropy of predicting token t + 2."""
    mtp = subtree(params, "mtp/")
    nxt = zero_pad(tokens[..., 1:], -1, 0, 1)
    e = _embed(params["embed"], nxt).to(h.dtype)
    z = torch.cat([rms_norm(h, mtp["norm_h"], cfg.norm_eps),
                   rms_norm(e, mtp["norm_e"], cfg.norm_eps)], -1)
    z, _, _ = layer_apply(cfg, subtree(mtp, "layer/"), HEAD_KIND,
                          linear(z, mtp["proj"]), window=window)
    logits = linear(rms_norm(z, params["final_norm"], cfg.norm_eps),
                    params["lm_head"])
    return cross_entropy(logits[..., :-2, :], tokens[..., 2:],
                         keep=tokens.dim() - 2)


def lm_loss_metrics(cfg, params, batch, *, remat=False):
    """(next-token cross-entropy + 0.3 x the MTP loss + the MoE layers'
    summed load-balance loss, {"ce", "mtp_ce" (with ``mtp``), "aux": a
    float32 scalar, 0.0 without a MoE layer}) — the reference's
    ``lm_loss``. ``remat``: see ``_forward``."""
    tokens = batch["tokens"]
    window = cfg.sliding_window
    logits, aux, _, h = _forward(cfg, params, tokens, window, False,
                                 with_aux=True, remat=remat)
    ce = cross_entropy(logits[..., :-1, :], tokens[..., 1:],
                       keep=tokens.dim() - 2)
    loss, metrics = ce, {"ce": ce}
    if cfg.mtp:
        metrics["mtp_ce"] = _mtp_ce(cfg, params, tokens, h, window)
        loss = loss + 0.3 * metrics["mtp_ce"]
    metrics["aux"] = aux
    return loss + aux, metrics


def lm_loss(cfg, params, batch):
    """The loss of ``lm_loss_metrics`` alone (one per client for a stacked
    cohort, whose dense families have no aux loss); the JAX package
    returns (loss, metrics)."""
    return lm_loss_metrics(cfg, params, batch)[0]


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


def lm_loss_masked_metrics(cfg, params, batch, *, remat=False):
    """(masked next-token cross-entropy over the valid target positions
    of a batch + the MoE layers' load-balance loss, {"ce", "aux"}) — the
    reference's ``lm_loss_masked``; batch["tokens"] (..., B, S),
    batch["m"] (..., B) or (..., B, S). Padded positions weigh 0: the loss
    does not depend on their content and their gradient is exactly zero
    (a fully padded batch leaves the params unchanged bit for bit). The
    aux loss is not masked (the federated twins train dense models, whose
    aux is 0.0). ``remat``: see ``_forward``."""
    tokens = batch["tokens"]
    logits, aux, _, _ = _forward(cfg, params, tokens, cfg.sliding_window,
                                 False, with_aux=True, remat=remat)
    w = _token_weights(tokens, batch["m"])
    ce = cross_entropy(logits[..., :-1, :], tokens[..., 1:], mask=w,
                       keep=tokens.dim() - 2)
    return ce + aux, {"ce": ce, "aux": aux}


def lm_loss_masked(cfg, params, batch, *, remat=False):
    """The loss of ``lm_loss_masked_metrics`` alone (one per client for a
    stacked cohort) — the federated twins' loss."""
    return lm_loss_masked_metrics(cfg, params, batch, remat=remat)[0]


def lm_accuracy_masked(cfg, params, tokens, m):
    """Masked greedy next-token accuracy (Alg. 1 line 11's local metric);
    0.0 on an empty mask."""
    logits = lm_forward(cfg, params, tokens, window=cfg.sliding_window)
    correct = (bi.argmax(logits[..., :-1, :]) == tokens[..., 1:]).float()
    return bi.masked_mean(correct, _token_weights(tokens, m),
                          correct.dim() - 2)


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
    cache = prefixed("blocks/", stacked_cache_init(cfg, batch, cache_len,
                                                   device))
    for i in range(cfg.first_dense_layers):
        cache.update(prefixed(f"head_layers/{i}/", layer_cache_init(
            cfg, HEAD_KIND, batch, cache_len, device)))
    cache["index"] = 0
    if ring:
        cache["slot_pos"] = torch.full((cache_len,), -1, dtype=torch.int32,
                                       device=device)
    return cache


def lm_prefill(cfg, params, tokens, target_len: Optional[int] = None):
    """Prefill: tokens (B, S) -> (last-position logits (B, V), a decode
    cache of the S positions, grown to ``target_len`` when it is
    longer)."""
    s = tokens.shape[1]
    logits, _, caches, _ = _forward(cfg, params, tokens, cfg.sliding_window,
                                    True)
    cache = {**caches, "index": s}
    if target_len is not None and target_len > s:
        cache = grow_cache(cache, target_len - s)
    return logits[:, -1], cache


_POSITION_AXIS = {"k": -3, "v": -3, "ckv": -2, "kr": -2}


def grow_cache(cache, extra: int):
    """The cache with its self-attention caches padded by ``extra`` zero
    positions on their position axis (-3 of k/v, -2 of the MLA latent
    and rope key); every other leaf (SSM states, the encoder's xk/xv) as
    it is."""
    out = {}
    for key, x in cache.items():
        axis = _POSITION_AXIS.get(key.rsplit("/", 1)[-1])
        out[key] = x if axis is None else zero_pad(x, axis, 0, extra)
    return out


def lm_decode_step(cfg, params, cache, token):
    """token (B, 1) -> (logits (B, V), the cache advanced by one position;
    its tensors are updated in place)."""
    index = cache["index"]
    slot_pos = cache.get("slot_pos")
    window = cfg.sliding_window if slot_pos is None else None
    h = constrain(_embed(params["embed"], token).to(dtype_of(cfg)), "dec")
    new_cache = dict(cache)
    for i in range(cfg.first_dense_layers):
        pre = f"head_layers/{i}/"
        h, c = layer_decode(cfg, subtree(params, pre), HEAD_KIND, h,
                            subtree(cache, pre), index, slot_pos=slot_pos,
                            window=window)
        new_cache.update(prefixed(pre, c))
    h, blocks = scan_blocks_decode(cfg, subtree(params, "blocks/"), h,
                                   subtree(cache, "blocks/"), index,
                                   slot_pos=slot_pos, window=window)
    new_cache.update(prefixed("blocks/", blocks))
    hn = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = linear(hn[:, 0], params["lm_head"])
    new_cache["index"] = index + 1
    return logits, new_cache
