"""Family-dispatching public model API of the zoo:

    init(cfg, key, device)                  -> params
    loss(cfg, params, batch, remat)         -> (loss, metrics)
    loss_masked(cfg, params, batch, remat)  -> (loss, metrics)
    prefill(cfg, params, batch, target_len) -> (last logits, cache)
    decode_step(cfg, params, cache, token)  -> (logits, cache)
    cache_init(cfg, batch, seq_len, device, src_len) -> decode cache
    supports_shape(cfg, shape)              -> (ok, reason)

An encoder-decoder config (``is_encoder_decoder``) goes to
``models/encdec.py``, whose batches carry ``src`` (B, S_src, d) frame
embeddings beside the target ``tokens``; every other config to
``models/transformer.py``. ``input_specs`` (shape stand-ins for the dry
run) comes with the dry run.

``init`` and ``cache_init`` build on the GPU unless the caller passes
``device="cpu"``, and raise where CUDA is absent
(``device.resolve_device``).
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf


def _is_encdec(cfg) -> bool:
    return cfg.is_encoder_decoder


def init(cfg: ModelConfig, key: Union[int, torch.Generator] = 0,
         device: DeviceLike = None):
    """Parameters on ``device``. ``key`` is a seed, drawn from a generator
    on ``device`` (on a card, the draw never passes through the host), or
    a ``torch.Generator``, drawn on its own device."""
    device = resolve_device(device)
    generator = (key if isinstance(key, torch.Generator)
                 else torch.Generator(device=device).manual_seed(int(key)))
    if _is_encdec(cfg):
        return ed.encdec_init(generator, cfg, device=device)
    return tf.lm_init(generator, cfg, device=device)


def loss(cfg, params, batch, *, remat=False):
    """(loss, metrics), the reference's: for a decoder-only model the
    next-token cross-entropy + 0.3 x the MTP loss + the MoE load-balance
    loss, {"ce", "mtp_ce" (with ``mtp``), "aux": 0.0 without a MoE
    layer}; for an encoder-decoder the target's cross-entropy, {"ce"}.
    ``remat`` rematerialises each stacked block in the backward."""
    if _is_encdec(cfg):
        return ed.encdec_loss(cfg, params, batch, remat=remat)
    return tf.lm_loss_metrics(cfg, params, batch, remat=remat)


def loss_masked(cfg, params, batch, *, remat=False):
    """Masked-batch twin of ``loss`` — the federated cohort contract
    (batch["m"] {0,1} validity; padded rows contribute exactly zero loss
    and gradient): (loss, {"ce", "aux"}). Decoder-only families only: an
    encoder-decoder raises ``ValueError`` (the reference asserts)."""
    if _is_encdec(cfg):
        raise ValueError("masked federated loss: decoder-only models")
    return tf.lm_loss_masked_metrics(cfg, params, batch, remat=remat)


def prefill(cfg, params, batch, target_len=None):
    if _is_encdec(cfg):
        return ed.encdec_prefill(cfg, params, batch["src"], batch["tokens"],
                                 target_len or batch["tokens"].shape[1])
    return tf.lm_prefill(cfg, params, batch["tokens"], target_len=target_len)


def decode_step(cfg, params, cache, token):
    if _is_encdec(cfg):
        return ed.encdec_decode_step(cfg, params, cache, token)
    return tf.lm_decode_step(cfg, params, cache, token)


def cache_init(cfg, batch: int, seq_len: int, device: DeviceLike = None,
               src_len: int = 0):
    """A zero decode cache; an encoder-decoder's also holds ``src_len``
    encoder positions (default ``_default_src_len``)."""
    device = resolve_device(device)
    if _is_encdec(cfg):
        return ed.encdec_cache_init(cfg, batch, seq_len,
                                    src_len or _default_src_len(cfg, seq_len),
                                    device)
    return tf.lm_cache_init(cfg, batch, seq_len, device)


def _default_src_len(cfg, seq_len: int) -> int:
    """The encoder's frames for a target of ``seq_len``, capped at 4,096
    (a 524,288-token target does not imply as many frames; that shape is
    skipped for the encoder-decoder anyway)."""
    return min(seq_len, 4096)


def supports_shape(cfg: ModelConfig, shape: InputShape):
    """(ok, reason): the long_500k policy of the JAX package."""
    if shape.name == "long_500k":
        if _is_encdec(cfg):
            return False, ("enc-dec speech decoder: 500k-token target "
                           "sequence skipped (DESIGN.md)")
        if cfg.family == "ssm" or cfg.attn_layer_period:
            return True, "native sub-quadratic (SSM state / hybrid)"
        if cfg.sliding_window or cfg.long_context_window:
            return True, "sliding-window variant"
        return False, "pure full-attention arch without SWA variant"
    return True, ""
