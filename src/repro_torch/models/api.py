"""Family-dispatching public model API of the zoo:

    init(cfg, key, device)                  -> params
    loss(cfg, params, batch, remat)         -> (loss, metrics)
    loss_masked(cfg, params, batch, remat)  -> (loss, metrics)
    prefill(cfg, params, batch, target_len) -> (last logits, cache)
    decode_step(cfg, params, cache, token)  -> (logits, cache)
    cache_init(cfg, batch, seq_len, device, src_len) -> decode cache
    input_specs(cfg, shape)                 -> dict of meta-tensor inputs
    supports_shape(cfg, shape)              -> (ok, reason)

An encoder-decoder config (``is_encoder_decoder``) goes to
``models/encdec.py``, whose batches carry ``src`` (B, S_src, d) frame
embeddings beside the target ``tokens``; every other config to
``models/transformer.py``.

``init`` and ``cache_init`` build on the GPU unless the caller passes
``device="cpu"``, and raise where CUDA is absent
(``device.resolve_device``). On ``device="meta"`` they build the same
names, shapes and dtypes and allocate and draw nothing: the port's
``jax.eval_shape(api.init)``, which the dry run (``launch/dryrun.py``)
traces steps on, with ``input_specs``' inputs.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.random import PRNGKey


def _is_encdec(cfg) -> bool:
    return cfg.is_encoder_decoder


def init(cfg: ModelConfig, key: Union[int, torch.Tensor] = 0,
         device: DeviceLike = None):
    """The reference's ``init(cfg, key)``, drawn on ``device`` (on a card
    the draw never passes through the host). ``key`` is a seed, taken as
    ``random.PRNGKey(key)``, or a key. On ``meta`` nothing is drawn."""
    device = resolve_device(device)
    key = (key.to(device) if isinstance(key, torch.Tensor)
           else PRNGKey(key, device))
    if _is_encdec(cfg):
        return ed.encdec_init(key, cfg)
    return tf.lm_init(key, cfg)


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


def input_specs(cfg: ModelConfig, shape: InputShape):
    """Every model input of ``shape`` as ``meta`` tensors (the reference's
    shapes and dtypes; nothing allocated): train and prefill ``tokens``
    (B, S) int32 and, for an encoder-decoder, ``src`` (B,
    ``_default_src_len``, d) float32 frame embeddings; decode ``cache``,
    ``cache_init``'s cache for S positions on ``meta`` (its ``index`` a
    host int, 0), and ``token`` (B, 1) int32."""
    b, s = shape.global_batch, shape.seq_len
    meta = dict(device="meta")
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": torch.empty((b, s), dtype=torch.int32, **meta)}
        if _is_encdec(cfg):
            specs = {"src": torch.empty((b, _default_src_len(cfg, s),
                                         cfg.d_model), dtype=torch.float32,
                                        **meta), **specs}
        return specs
    return {"cache": cache_init(cfg, b, s, device="meta"),
            "token": torch.empty((b, 1), dtype=torch.int32, **meta)}


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
