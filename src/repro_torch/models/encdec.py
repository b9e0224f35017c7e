"""Encoder-decoder backbone (the Seamless-M4T medium transformer backbone,
arXiv:2308.11596), the JAX package's ``models/encdec.py``. The modality
frontend is a stub, as there: the encoder takes precomputed frame
embeddings ``src`` (B, S_src, d) (the mel-spectrogram and conv feature
extractor's output), projected by one linear layer, through
``encoder_layers`` bidirectional attention + SwiGLU layers. The decoder is
a causal transformer whose every layer also cross-attends to the
encoder's output.

Parameters are a flat dict: ``src_proj`` (d, d), ``enc_blocks/layers/0/...``
(leading axis ``encoder_layers``), ``enc_norm``, ``embed`` (V, d),
``dec_blocks/layers/0/...`` (leading axis ``n_layers``, each layer with
``norm_x`` and ``cross/{wq,wk,wv,wo}``), ``final_norm``, ``lm_head``. A
decode cache: ``blocks/layers/0/{k,v}`` (the decoder's self-attention) and
``{xk,xv}`` (the encoder's keys and values for the cross-attention,
computed once at prefill) and ``index``, a host int.

The encoder's attention and the cross-attention at prefill go through K3
with ``causal=False``, the decoder's self-attention through K3 (causal);
at decode the self- and cross-attention go through K4. The reference
computes the first two with its plain ``sdpa``: the same function.
``remat`` rematerialises the encoder's and the decoder's blocks in the
backward (``blocks.scan_blocks``), as the reference's ``jax.checkpoint``
does their scan steps.
"""
from __future__ import annotations

import torch

from repro_torch.models.blocks import (scan_blocks, scan_blocks_decode,
                                       stacked_blocks_init, stacked_cache_init)
from repro_torch.models.common import (cross_entropy, dense_init, dtype_of,
                                       embed_init, linear, ones, prefixed,
                                       rms_norm, subtree)
from repro_torch.models.transformer import _embed, grow_cache
from repro_torch.random import split
from repro_torch.sharding.ctx import constrain


def encdec_init(key: torch.Tensor, cfg):
    """The reference's ``encdec_init`` from ``key``, drawn on the key's
    device, each leaf from the reference's subkey."""
    ks = split(key, 8)
    dt, d, dev = dtype_of(cfg), cfg.d_model, key.device
    params = {"src_proj": dense_init(ks[0], (d, d), dt)}
    params.update(prefixed("enc_blocks/", stacked_blocks_init(
        ks[1], cfg, n_blocks=cfg.encoder_layers)))
    params["enc_norm"] = ones((d,), dt, dev)
    params["embed"] = embed_init(ks[2], (cfg.vocab_size, d), dt)
    params.update(prefixed("dec_blocks/", stacked_blocks_init(
        ks[3], cfg, cross_attention=True)))
    params["final_norm"] = ones((d,), dt, dev)
    params["lm_head"] = dense_init(ks[4], (d, cfg.vocab_size), dt)
    return params


def _encode(cfg, params, src, remat=False):
    """src (B, S_src, d) frame embeddings -> the encoder's output (B,
    S_src, d): the projection, the bidirectional layers, the norm."""
    h = constrain(linear(src.to(dtype_of(cfg)), params["src_proj"]), "act")
    h, _, _ = scan_blocks(cfg, subtree(params, "enc_blocks/"), h,
                          with_aux=False, causal=False, remat=remat)
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def encdec_forward(cfg, params, src, tokens, *, return_cache=False,
                   remat=False):
    """Teacher-forced forward: src (B, S_src, d), tokens (B, S_tgt) ->
    (logits (B, S_tgt, V), the decoder's MoE aux loss (0.0: its layers are
    dense), the decoder's layer caches under a decode cache's keys or
    None, the encoder's output)."""
    enc_out = _encode(cfg, params, src, remat=remat)
    h = constrain(_embed(params["embed"], tokens).to(dtype_of(cfg)), "act")
    h, aux, caches = scan_blocks(cfg, subtree(params, "dec_blocks/"), h,
                                 enc_out=enc_out, return_cache=return_cache,
                                 remat=remat)
    logits = constrain(linear(rms_norm(h, params["final_norm"], cfg.norm_eps),
                              params["lm_head"]), "logits")
    if caches is not None:
        caches = prefixed("blocks/", caches)
    return logits, aux, caches, enc_out


def encdec_loss(cfg, params, batch, *, remat=False):
    """(next-token cross-entropy of the target + aux, {"ce": the same}),
    as the reference's."""
    tokens = batch["tokens"]
    logits, aux, _, _ = encdec_forward(cfg, params, batch["src"], tokens,
                                       remat=remat)
    loss = cross_entropy(logits[:, :-1], tokens[:, 1:]) + aux
    return loss, {"ce": loss}


def encdec_cache_init(cfg, batch: int, seq_len: int, src_len: int, device):
    """A zero decode cache: ``seq_len`` target positions, ``src_len``
    encoder positions, index 0."""
    return {**prefixed("blocks/", stacked_cache_init(
        cfg, batch, seq_len, device, cross_len=src_len)), "index": 0}


def encdec_prefill(cfg, params, src, bos_tokens, target_len: int):
    """Encode ``src`` and run the decoder over ``bos_tokens`` (B, S) ->
    (the last position's logits (B, V), a decode cache of the S positions
    and the encoder's keys and values, grown to ``target_len`` when it is
    longer)."""
    logits, _, caches, _ = encdec_forward(cfg, params, src, bos_tokens,
                                          return_cache=True)
    s = bos_tokens.shape[1]
    cache = {**caches, "index": s}
    if target_len > s:
        cache = grow_cache(cache, target_len - s)
    return logits[:, -1], cache


def encdec_decode_step(cfg, params, cache, token):
    """One decoder token (B, 1) -> (logits (B, V), the cache advanced by
    one position; its tensors are updated in place). The cross-attention
    reads the encoder's keys and values from the cache."""
    index = cache["index"]
    h = constrain(_embed(params["embed"], token).to(dtype_of(cfg)), "dec")
    h, blocks = scan_blocks_decode(cfg, subtree(params, "dec_blocks/"), h,
                                   subtree(cache, "blocks/"), index)
    logits = linear(rms_norm(h, params["final_norm"], cfg.norm_eps)[:, 0],
                    params["lm_head"])
    return logits, {**prefixed("blocks/", blocks), "index": index + 1}
