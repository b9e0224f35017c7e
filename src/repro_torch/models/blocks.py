"""Transformer super-blocks: init, full-sequence apply (train / prefill) and
single-token decode of the pre-norm layers of the ported families —
attention + SwiGLU MLP (dense, vlm) or a Mamba2 mixer alone (ssm) —
stacked over ``cfg.n_blocks``, with their decode caches.

A super-block is ``cfg.block_len`` consecutive layers (1 in the ported
families). Parameters are flat dicts: a layer's leaves are ``norm1``,
``mixer/<w>`` and, with an MLP, ``norm2`` and ``mlp/<w>``; a block's
``layers/<i>/<leaf>``; the stacked blocks carry a leading ``n_blocks``
axis on every leaf (after the client axis, in a stacked cohort). Decode
caches are flat dicts the same way: ``layers/<i>/k`` and ``v`` (B, C,
Hkv, D) of an attention layer, ``layers/<i>/conv`` (B, K-1, ch) and
``state`` (B, H, N, P) float32 of an SSM layer, stacked likewise.
``scan_blocks`` and ``scan_blocks_decode`` are Python loops over the
stacked axis — the JAX package's ``lax.scan``.

The MoE, MLA and cross-attention branches of the JAX package come with
later slices of the port: a config that would reach them raises in
``ModelConfig``.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import attn_apply, attn_decode, attn_init
from repro_torch.models.common import (dtype_of, ones, prefixed, rms_norm,
                                       subtree, swiglu_apply, swiglu_init)
from repro_torch.models.ssm import ssm_apply, ssm_decode, ssm_init


# ---------------------------------------------------------------------- #
# Init
# ---------------------------------------------------------------------- #
def layer_init(generator: torch.Generator, cfg, kind):
    """One layer's leaves, drawn on the generator's device."""
    dt, d, dev = dtype_of(cfg), cfg.d_model, generator.device
    p = {"norm1": ones((d,), dt, dev)}
    if kind["mixer"] == "attn":
        p.update(prefixed("mixer/", attn_init(generator, cfg)))
    else:
        p.update(prefixed("mixer/", ssm_init(generator, cfg)))
    if kind["mlp"] != "none":
        p["norm2"] = ones((d,), dt, dev)
        p.update(prefixed("mlp/", swiglu_init(generator, d, cfg.d_ff, dt)))
    return p


def block_init(generator: torch.Generator, cfg):
    out = {}
    for i, kind in enumerate(cfg.block_pattern()):
        out.update(prefixed(f"layers/{i}/", layer_init(generator, cfg, kind)))
    return out


def stacked_blocks_init(generator: torch.Generator, cfg, n_blocks=None,
                        device=None):
    """The ``n_blocks`` blocks' leaves stacked on a leading axis, on
    ``device`` (default: the generator's). Drawn block by block, in order,
    into tensors allocated once: only one block's leaves exist apart from
    the stack (a 22 B-parameter model has room on one card only so)."""
    n = n_blocks if n_blocks is not None else cfg.n_blocks
    device = generator.device if device is None else device
    first = block_init(generator, cfg)
    out = {k: torch.empty((n, *v.shape), dtype=v.dtype, device=device)
           for k, v in first.items()}
    for i in range(n):
        block = first if i == 0 else block_init(generator, cfg)
        for k, v in block.items():
            out[k][i].copy_(v)
        del block
    return out


# ---------------------------------------------------------------------- #
# Decode caches
# ---------------------------------------------------------------------- #
def layer_cache_init(cfg, kind, batch: int, cache_len: int, device):
    dt = dtype_of(cfg)
    if kind["mixer"] == "attn":
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    ch = d_in + 2 * s.n_groups * s.d_state
    return {"conv": torch.zeros((batch, s.conv_kernel - 1, ch), dtype=dt,
                                device=device),
            "state": torch.zeros((batch, d_in // s.head_dim, s.d_state,
                                  s.head_dim), dtype=torch.float32,
                                 device=device)}


def block_cache_init(cfg, batch: int, cache_len: int, device):
    out = {}
    for i, kind in enumerate(cfg.block_pattern()):
        out.update(prefixed(f"layers/{i}/", layer_cache_init(
            cfg, kind, batch, cache_len, device)))
    return out


def stacked_cache_init(cfg, batch: int, cache_len: int, device,
                       n_blocks=None):
    """Zero caches with a leading ``n_blocks`` axis (each its own memory:
    decode writes them in place)."""
    n = n_blocks if n_blocks is not None else cfg.n_blocks
    one = block_cache_init(cfg, batch, cache_len, device)
    return {k: torch.zeros((n, *v.shape), dtype=v.dtype, device=device)
            for k, v in one.items()}


# ---------------------------------------------------------------------- #
# Apply: full sequence (train / prefill)
# ---------------------------------------------------------------------- #
def layer_apply(cfg, p, kind, h, *, window=None):
    """Pre-norm layer: h + mixer(norm1(h)), then, with an MLP, +
    mlp(norm2(h)). Returns (h, the layer's cache: the rotated k/v of an
    attention layer, the conv and SSM states of an SSM layer)."""
    hin = rms_norm(h, p["norm1"], cfg.norm_eps)
    if kind["mixer"] == "attn":
        y, (k, v) = attn_apply(cfg, subtree(p, "mixer/"), hin, window=window)
        cache = {"k": k, "v": v}
    else:
        y, (conv, state) = ssm_apply(cfg, subtree(p, "mixer/"), hin)
        cache = {"conv": conv, "state": state}
    h = h + y
    if kind["mlp"] != "none":
        h = h + swiglu_apply(subtree(p, "mlp/"),
                             rms_norm(h, p["norm2"], cfg.norm_eps))
    return h, cache


def block_apply(cfg, bp, h, *, window=None):
    caches = {}
    for i, kind in enumerate(cfg.block_pattern()):
        h, c = layer_apply(cfg, subtree(bp, f"layers/{i}/"), kind, h,
                           window=window)
        caches.update(prefixed(f"layers/{i}/", c))
    return h, caches


def scan_blocks(cfg, stacked, h, *, window=None, return_cache=False):
    """Apply the ``n_blocks`` stacked blocks in order. h (B, S, d), or (N,
    B, S, d) for a stacked cohort, whose leaves are (N, n_blocks, ...).
    Returns (h, the caches stacked over blocks, or None without
    ``return_cache``)."""
    axis = h.dim() - 3
    caches = []
    for i in range(cfg.n_blocks):
        h, c = block_apply(cfg, {k: v.select(axis, i)
                                 for k, v in stacked.items()}, h,
                           window=window)
        if return_cache:
            caches.append(c)
    if not return_cache:
        return h, None
    return h, {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


# ---------------------------------------------------------------------- #
# Apply: single-token decode
# ---------------------------------------------------------------------- #
def layer_decode(cfg, p, kind, h, cache, index: int, *, slot_pos=None,
                 window=None):
    """One layer of one decode step; ``cache`` is the layer's (k, v
    written in place; the SSM states replaced). Returns (h, cache)."""
    hin = rms_norm(h, p["norm1"], cfg.norm_eps)
    cache = dict(cache)
    if kind["mixer"] == "attn":
        y, k, v, _ = attn_decode(cfg, subtree(p, "mixer/"), hin, cache["k"],
                                 cache["v"], index, slot_pos=slot_pos,
                                 window=window)
        cache.update(k=k, v=v)
    else:
        y, conv, state = ssm_decode(cfg, subtree(p, "mixer/"), hin,
                                    cache["conv"], cache["state"])
        cache.update(conv=conv, state=state)
    h = h + y
    if kind["mlp"] != "none":
        h = h + swiglu_apply(subtree(p, "mlp/"),
                             rms_norm(h, p["norm2"], cfg.norm_eps))
    return h, cache


def block_decode(cfg, bp, h, bcache, index: int, *, slot_pos=None,
                 window=None):
    new = {}
    for i, kind in enumerate(cfg.block_pattern()):
        pre = f"layers/{i}/"
        h, c = layer_decode(cfg, subtree(bp, pre), kind, h,
                            subtree(bcache, pre), index, slot_pos=slot_pos,
                            window=window)
        new.update(prefixed(pre, c))
    return h, new


def scan_blocks_decode(cfg, stacked, h, caches, index: int, *,
                       slot_pos=None, window=None):
    """One decode step through the stacked blocks. ``caches`` (leaves
    (n_blocks, ...)) are updated in place — the attention k/v written at
    the new position, the SSM conv and state leaves overwritten — and
    returned."""
    for i in range(cfg.n_blocks):
        bp = {k: v[i] for k, v in stacked.items()}
        bc = {k: v[i] for k, v in caches.items()}
        h, new = block_decode(cfg, bp, h, bc, index, slot_pos=slot_pos,
                              window=window)
        for k, v in new.items():
            if v is not bc[k]:
                caches[k][i].copy_(v)
    return h, caches
