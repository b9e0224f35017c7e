"""Family-dispatching public model API of the decoder-only zoo:

    init(cfg, key, device)                  -> params
    loss(cfg, params, batch)                -> (loss, metrics)
    prefill(cfg, params, batch, target_len) -> (last logits, cache)
    decode_step(cfg, params, cache, token)  -> (logits, cache)
    cache_init(cfg, batch, seq_len, device) -> decode cache
    supports_shape(cfg, shape)              -> (ok, reason)

The JAX package's API also dispatches to the encoder-decoder; that family
comes with a later slice of the port, and its configs raise in
``ModelConfig``. ``input_specs`` (shape stand-ins for the dry run) comes
with the dry run.

``init`` and ``cache_init`` build on the GPU unless the caller passes
``device="cpu"``, and raise where CUDA is absent
(``device.resolve_device``).
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf


def init(cfg: ModelConfig, key: Union[int, torch.Generator] = 0,
         device: DeviceLike = None):
    """Parameters on ``device``. ``key`` is a seed, drawn from a generator
    on ``device`` (on a card, the draw never passes through the host), or
    a ``torch.Generator``, drawn on its own device."""
    device = resolve_device(device)
    generator = (key if isinstance(key, torch.Generator)
                 else torch.Generator(device=device).manual_seed(int(key)))
    return tf.lm_init(generator, cfg, device=device)


def loss(cfg, params, batch):
    """(next-token cross-entropy, {"ce": it, "aux": 0.0}): the ported
    families have no auxiliary loss."""
    ce = tf.lm_loss(cfg, params, batch)
    return ce, {"ce": ce, "aux": 0.0}


def prefill(cfg, params, batch, target_len=None):
    return tf.lm_prefill(cfg, params, batch["tokens"], target_len=target_len)


def decode_step(cfg, params, cache, token):
    return tf.lm_decode_step(cfg, params, cache, token)


def cache_init(cfg, batch: int, seq_len: int, device: DeviceLike = None):
    return tf.lm_cache_init(cfg, batch, seq_len, resolve_device(device))


def supports_shape(cfg: ModelConfig, shape: InputShape):
    """(ok, reason): the long_500k policy of the JAX package."""
    if shape.name == "long_500k":
        if cfg.family == "ssm" or cfg.attn_layer_period:
            return True, "native sub-quadratic (SSM state / hybrid)"
        if cfg.sliding_window or cfg.long_context_window:
            return True, "sliding-window variant"
        return False, "pure full-attention arch without SWA variant"
    return True, ""
