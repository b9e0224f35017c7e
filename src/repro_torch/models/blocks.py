"""Transformer super-blocks of the dense family: init and full-sequence
apply of pre-norm layers (attention + SwiGLU MLP), stacked over
``cfg.n_blocks``.

A super-block is ``cfg.block_len`` consecutive layers (1 in the dense
family). Parameters are flat dicts: a layer's leaves are ``norm1``,
``mixer/<w>``, ``norm2``, ``mlp/<w>``; a block's ``layers/<i>/<leaf>``;
the stacked blocks carry a leading ``n_blocks`` axis on every leaf (after
the client axis, in a stacked cohort). ``scan_blocks`` is a Python loop
over that axis — the JAX package's ``lax.scan``.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import attn_apply, attn_init
from repro_torch.models.common import (dtype_of, ones, prefixed, rms_norm,
                                       subtree, swiglu_apply, swiglu_init)


def layer_init(generator: torch.Generator, cfg):
    dt, d = dtype_of(cfg), cfg.d_model
    return {"norm1": ones((d,), dt),
            **prefixed("mixer/", attn_init(generator, cfg)),
            "norm2": ones((d,), dt),
            **prefixed("mlp/", swiglu_init(generator, d, cfg.d_ff, dt))}


def block_init(generator: torch.Generator, cfg):
    out = {}
    for i, _ in enumerate(cfg.block_pattern()):
        out.update(prefixed(f"layers/{i}/", layer_init(generator, cfg)))
    return out


def stacked_blocks_init(generator: torch.Generator, cfg, n_blocks=None):
    n = n_blocks if n_blocks is not None else cfg.n_blocks
    blocks = [block_init(generator, cfg) for _ in range(n)]
    return {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}


def layer_apply(cfg, p, h, *, window=None):
    """Pre-norm layer: h + attn(norm1(h)), then + mlp(norm2(h))."""
    y, _ = attn_apply(cfg, subtree(p, "mixer/"),
                      rms_norm(h, p["norm1"], cfg.norm_eps), window=window)
    h = h + y
    return h + swiglu_apply(subtree(p, "mlp/"),
                            rms_norm(h, p["norm2"], cfg.norm_eps))


def block_apply(cfg, bp, h, *, window=None):
    for i, _ in enumerate(cfg.block_pattern()):
        h = layer_apply(cfg, subtree(bp, f"layers/{i}/"), h, window=window)
    return h


def scan_blocks(cfg, stacked, h, *, window=None):
    """Apply the ``n_blocks`` stacked blocks in order. h (B, S, d), or (N,
    B, S, d) for a stacked cohort, whose leaves are (N, n_blocks, ...)."""
    axis = h.dim() - 3
    for i in range(cfg.n_blocks):
        h = block_apply(cfg, {k: v.select(axis, i)
                              for k, v in stacked.items()}, h, window=window)
    return h
