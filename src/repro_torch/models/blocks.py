"""Transformer super-blocks: init, full-sequence apply (train / prefill) and
single-token decode of the pre-norm layers of the ported families —
attention + SwiGLU MLP (dense, vlm), attention + MoE MLP (moe), a Mamba2
mixer alone (ssm), or the hybrid's interleave of Mamba2 and attention
layers, each with a dense or MoE MLP — stacked over ``cfg.n_blocks``, with
their decode caches.

A super-block is ``cfg.block_len`` consecutive layers (1 for homogeneous
stacks; 8 for Jamba's 7 Mamba2 + 1 attention layers; 2 when MoE
alternates with dense MLPs). Parameters are flat dicts: a layer's leaves are ``norm1``,
``mixer/<w>`` and, with an MLP, ``norm2`` and ``mlp/<w>``; a block's
``layers/<i>/<leaf>``; the stacked blocks carry a leading ``n_blocks``
axis on every leaf (after the client axis, in a stacked cohort). Decode
caches are flat dicts the same way: ``layers/<i>/k`` and ``v`` (B, C,
Hkv, D) of an attention layer, ``layers/<i>/conv`` (B, K-1, ch) and
``state`` (B, H, N, P) float32 of an SSM layer, stacked likewise (a
hybrid block holds both kinds side by side). ``scan_blocks`` and
``scan_blocks_decode`` are Python loops over the stacked axis — the JAX
package's ``lax.scan``. The full-sequence functions return the MoE
layers' load-balance loss summed in the reference's order (0.0 without a
MoE layer); decode leaves it out, as the reference discards it there.

The MLA and cross-attention branches of the JAX package come with later
slices of the port: a config that would reach them raises in
``ModelConfig``.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import attn_apply, attn_decode, attn_init
from repro_torch.models.common import (dtype_of, ones, prefixed, rms_norm,
                                       subtree, swiglu_apply, swiglu_init)
from repro_torch.models.moe import moe_apply, moe_init
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
        p.update(prefixed("mlp/", moe_init(generator, cfg)
                          if kind["mlp"] == "moe"
                          else swiglu_init(generator, d, cfg.d_ff, dt)))
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
def _mlp(cfg, p, kind, h, with_aux: bool):
    """(mlp(norm2(h)), the MoE aux loss, or 0.0 without a MoE layer or
    ``with_aux``); ``p`` the layer's."""
    h2 = rms_norm(h, p["norm2"], cfg.norm_eps)
    if kind["mlp"] == "moe":
        y, aux = moe_apply(cfg, subtree(p, "mlp/"), h2, with_aux=with_aux)
        return y, 0.0 if aux is None else aux
    return swiglu_apply(subtree(p, "mlp/"), h2), 0.0


def layer_apply(cfg, p, kind, h, *, window=None, with_aux=True):
    """Pre-norm layer: h + mixer(norm1(h)), then, with an MLP, +
    mlp(norm2(h)). Returns (h, the MoE aux loss or 0.0 — 0.0 too without
    ``with_aux``, which prefill leaves out, as the reference's jit drops
    the unused loss — and the layer's cache: the rotated k/v of an
    attention layer, the conv and SSM states of an SSM layer)."""
    hin = rms_norm(h, p["norm1"], cfg.norm_eps)
    if kind["mixer"] == "attn":
        y, (k, v) = attn_apply(cfg, subtree(p, "mixer/"), hin, window=window)
        cache = {"k": k, "v": v}
    else:
        y, (conv, state) = ssm_apply(cfg, subtree(p, "mixer/"), hin)
        cache = {"conv": conv, "state": state}
    h = h + y
    aux = 0.0
    if kind["mlp"] != "none":
        y, aux = _mlp(cfg, p, kind, h, with_aux=with_aux)
        h = h + y
    return h, aux, cache


def block_apply(cfg, bp, h, *, window=None, with_aux=True):
    aux_total, caches = 0.0, {}
    for i, kind in enumerate(cfg.block_pattern()):
        h, aux, c = layer_apply(cfg, subtree(bp, f"layers/{i}/"), kind, h,
                                window=window, with_aux=with_aux)
        aux_total = aux_total + aux
        caches.update(prefixed(f"layers/{i}/", c))
    return h, aux_total, caches


def scan_blocks(cfg, stacked, h, *, window=None, return_cache=False,
                with_aux=True):
    """Apply the ``n_blocks`` stacked blocks in order. h (B, S, d), or (N,
    B, S, d) for a stacked cohort, whose leaves are (N, n_blocks, ...).
    Returns (h, the summed MoE aux loss, or 0.0 without a MoE layer or
    ``with_aux``, the caches stacked over blocks, or None without
    ``return_cache``)."""
    axis = h.dim() - 3
    aux, caches = 0.0, []
    for i in range(cfg.n_blocks):
        h, a, c = block_apply(cfg, {k: v.select(axis, i)
                                    for k, v in stacked.items()}, h,
                              window=window, with_aux=with_aux)
        aux = aux + a
        if return_cache:
            caches.append(c)
    if not return_cache:
        return h, aux, None
    return h, aux, {k: torch.stack([c[k] for c in caches])
                    for k in caches[0]}


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
        h = h + _mlp(cfg, p, kind, h, with_aux=False)[0]
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
