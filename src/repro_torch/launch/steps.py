"""Prefill and decode steps of the zoo (the JAX package's
``launch/steps.py``; its train step and ``init_state`` need ``optim/`` and
come with training). PyTorch runs eagerly, so a step is a plain closure
over the config. A prefill batch holds ``tokens`` (B, S) and, for an
encoder-decoder, ``src`` (B, S_src, d) frame embeddings (``api.prefill``
reads both)."""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(params, batch, target_len=None):
        return api.prefill(cfg, params, batch, target_len=target_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    def decode_step(params, cache, token):
        return api.decode_step(cfg, params, cache, token)
    return decode_step
