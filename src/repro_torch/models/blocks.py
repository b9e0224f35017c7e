"""Transformer super-blocks: init, full-sequence apply (train / prefill) and
single-token decode of the pre-norm layers of the zoo — attention + SwiGLU
MLP (dense, vlm, DeepSeek's leading dense layers), attention + MoE MLP
(moe; DeepSeek's attention is MLA), a Mamba2 mixer alone (ssm), or the
hybrid's interleave of Mamba2 and attention layers, each with a dense or
MoE MLP; an encoder-decoder's decoder layers add a cross-attention to the
encoder's output — stacked over ``n_blocks``, with their decode caches.

A super-block is ``cfg.block_len`` consecutive layers (1 for homogeneous
stacks; 8 for Jamba's 7 Mamba2 + 1 attention layers; 2 when MoE
alternates with dense MLPs). Parameters are flat dicts: a layer's leaves
are ``norm1``, ``mixer/<w>``, with a cross-attention ``norm_x`` and
``cross/<w>``, and, with an MLP, ``norm2`` and ``mlp/<w>``; a block's
``layers/<i>/<leaf>``; the stacked blocks carry a leading ``n_blocks``
axis on every leaf (after the client axis, in a stacked cohort). Decode
caches are flat dicts the same way: ``layers/<i>/k`` and ``v`` (B, C,
Hkv, D) of an attention layer, ``ckv`` (B, C, kv_lora) and ``kr`` (B, C,
rope) of an MLA layer, ``xk`` and ``xv`` (B, S_src, Hkv, D) of a
cross-attention (the encoder's keys and values, written at prefill),
``conv`` (B, K-1, ch) and ``state`` (B, H, N, P) float32 of an SSM layer,
stacked likewise (a hybrid block holds both kinds side by side).
``scan_blocks`` and ``scan_blocks_decode`` are Python loops over the
stacked axis — the JAX package's ``lax.scan``; ``scan_blocks(remat=True)``
rematerialises each block in the backward, as ``jax.checkpoint`` does one
scan step. The full-sequence functions
return the MoE layers' load-balance loss summed in the reference's order
(0.0 without a MoE layer); decode leaves it out, as the reference discards
it there.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import (attn_apply, attn_decode, attn_init,
                                          cross_attn_apply, cross_attn_decode,
                                          encoder_kv)
from repro_torch.models.common import (dtype_of, ones, prefixed, rms_norm,
                                       subtree, swiglu_apply, swiglu_init)
from repro_torch.models.mla import mla_apply, mla_decode, mla_init
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.ssm import ssm_apply, ssm_decode, ssm_init
from repro_torch.random import split
from repro_torch.sharding.ctx import constrain


# ---------------------------------------------------------------------- #
# Init
# ---------------------------------------------------------------------- #
def layer_init(key: torch.Tensor, cfg, kind,
               cross_attention: bool = False):
    """One layer's leaves, drawn on the key's device from the reference's
    subkeys (mixer 0, MLP 1, cross-attention 3)."""
    ks = split(key, 4)
    dt, d, dev = dtype_of(cfg), cfg.d_model, key.device
    p = {"norm1": ones((d,), dt, dev)}
    if kind["mixer"] == "attn":
        p.update(prefixed("mixer/", mla_init(ks[0], cfg)
                          if cfg.mla is not None
                          else attn_init(ks[0], cfg)))
    else:
        p.update(prefixed("mixer/", ssm_init(ks[0], cfg)))
    if cross_attention:
        p["norm_x"] = ones((d,), dt, dev)
        p.update(prefixed("cross/", attn_init(ks[3], cfg)))
    if kind["mlp"] != "none":
        p["norm2"] = ones((d,), dt, dev)
        p.update(prefixed("mlp/", moe_init(ks[1], cfg)
                          if kind["mlp"] == "moe"
                          else swiglu_init(ks[1], d, cfg.d_ff, dt)))
    return p


def block_init(key: torch.Tensor, cfg, cross_attention: bool = False):
    pattern = cfg.block_pattern()
    ks = split(key, len(pattern))
    out = {}
    for i, kind in enumerate(pattern):
        out.update(prefixed(f"layers/{i}/", layer_init(
            ks[i], cfg, kind, cross_attention)))
    return out


def stacked_blocks_init(key: torch.Tensor, cfg, n_blocks=None,
                        cross_attention: bool = False):
    """The ``n_blocks`` blocks' leaves stacked on a leading axis, drawn on
    the key's device, block i from the reference's i-th subkey. Drawn
    block by block into tensors allocated once: only one block's leaves
    exist apart from the stack (a 22 B-parameter model has room on one
    card only so); one block is its leaves with the axis added, no copy
    (a DeepSeek MoE block is 11.3 B parameters)."""
    n = n_blocks if n_blocks is not None else cfg.n_blocks
    ks = split(key, n)
    first = block_init(ks[0], cfg, cross_attention)
    if n == 1:
        return {k: v[None] for k, v in first.items()}
    out = {k: torch.empty((n, *v.shape), dtype=v.dtype, device=v.device)
           for k, v in first.items()}
    for i in range(n):
        block = first if i == 0 else block_init(ks[i], cfg,
                                                cross_attention)
        for k, v in block.items():
            out[k][i].copy_(v)
        del block
    return out


# ---------------------------------------------------------------------- #
# Decode caches
# ---------------------------------------------------------------------- #
def layer_cache_init(cfg, kind, batch: int, cache_len: int, device,
                     cross_len: int = 0):
    dt = dtype_of(cfg)
    zeros = lambda *shape, dtype=dt: torch.zeros(shape, dtype=dtype,
                                                 device=device)
    if kind["mixer"] != "attn":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        ch = d_in + 2 * s.n_groups * s.d_state
        return {"conv": zeros(batch, s.conv_kernel - 1, ch),
                "state": zeros(batch, d_in // s.head_dim, s.d_state,
                               s.head_dim, dtype=torch.float32)}
    hkv, hd = cfg.n_kv_heads, cfg.head_dim
    if cfg.mla is not None:
        c = {"ckv": zeros(batch, cache_len, cfg.mla.kv_lora_rank),
             "kr": zeros(batch, cache_len, cfg.mla.qk_rope_head_dim)}
    else:
        c = {"k": zeros(batch, cache_len, hkv, hd),
             "v": zeros(batch, cache_len, hkv, hd)}
    if cross_len:
        c.update(xk=zeros(batch, cross_len, hkv, hd),
                 xv=zeros(batch, cross_len, hkv, hd))
    return c


def block_cache_init(cfg, batch: int, cache_len: int, device,
                     cross_len: int = 0):
    out = {}
    for i, kind in enumerate(cfg.block_pattern()):
        out.update(prefixed(f"layers/{i}/", layer_cache_init(
            cfg, kind, batch, cache_len, device, cross_len)))
    return out


def stacked_cache_init(cfg, batch: int, cache_len: int, device,
                       n_blocks=None, cross_len: int = 0):
    """Zero caches with a leading ``n_blocks`` axis (each its own memory:
    decode writes them in place)."""
    n = n_blocks if n_blocks is not None else cfg.n_blocks
    one = block_cache_init(cfg, batch, cache_len, device, cross_len)
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


def layer_apply(cfg, p, kind, h, *, window=None, with_aux=True,
                enc_out=None, causal=True):
    """Pre-norm layer: h + mixer(norm1(h)); with ``enc_out`` and a
    cross-attention, + cross(norm_x(h)) over the encoder's output; then,
    with an MLP, + mlp(norm2(h)). Returns (h, the MoE aux loss or 0.0 —
    0.0 too without ``with_aux``, which prefill leaves out, as the
    reference's jit drops the unused loss — and the layer's cache: the
    rotated k/v of an attention layer, the latent and rope key of an MLA
    layer, the conv and SSM states of an SSM layer, and the encoder's xk/xv
    of a cross-attention). ``causal=False`` makes the attention
    bidirectional (the encoder's layers)."""
    hin = rms_norm(h, p["norm1"], cfg.norm_eps)
    if kind["mixer"] == "attn" and cfg.mla is not None:
        y, (ckv, kr) = mla_apply(cfg, subtree(p, "mixer/"), hin,
                                 window=window)
        cache = {"ckv": ckv, "kr": kr}
    elif kind["mixer"] == "attn":
        y, (k, v) = attn_apply(cfg, subtree(p, "mixer/"), hin, window=window,
                               causal=causal)
        cache = {"k": k, "v": v}
    else:
        y, (conv, state) = ssm_apply(cfg, subtree(p, "mixer/"), hin)
        cache = {"conv": conv, "state": state}
    h = h + y
    if enc_out is not None and "norm_x" in p:
        cross = subtree(p, "cross/")
        xk, xv = encoder_kv(cfg, cross, enc_out)
        hx = rms_norm(h, p["norm_x"], cfg.norm_eps)
        h = h + cross_attn_apply(cfg, cross, hx, (xk, xv))
        if kind["mixer"] == "attn":
            cache.update(xk=xk, xv=xv)
    aux = 0.0
    if kind["mlp"] != "none":
        y, aux = _mlp(cfg, p, kind, h, with_aux=with_aux)
        h = h + y
    return constrain(h, "act"), aux, cache


def block_apply(cfg, bp, h, *, window=None, with_aux=True, enc_out=None,
                causal=True):
    aux_total, caches = 0.0, {}
    for i, kind in enumerate(cfg.block_pattern()):
        h, aux, c = layer_apply(cfg, subtree(bp, f"layers/{i}/"), kind, h,
                                window=window, with_aux=with_aux,
                                enc_out=enc_out, causal=causal)
        aux_total = aux_total + aux
        caches.update(prefixed(f"layers/{i}/", c))
    return h, aux_total, caches


def scan_blocks(cfg, stacked, h, *, window=None, return_cache=False,
                with_aux=True, enc_out=None, causal=True, remat=False):
    """Apply the stacked blocks in order (as many as the leaves' block
    axis holds: ``cfg.n_blocks``, or an encoder's ``encoder_layers``).
    h (B, S, d), or (N, B, S, d) for a stacked cohort, whose leaves are
    (N, n_blocks, ...). ``enc_out`` feeds the decoder layers'
    cross-attention, ``causal=False`` makes the attention bidirectional.
    ``remat`` recomputes each block's forward in the backward instead of
    keeping its activations (``torch.utils.checkpoint`` around one block,
    as the reference's ``jax.checkpoint`` wraps one scan step); the
    forward's results are the same bits. Returns (h, the summed MoE aux
    loss, or 0.0 without a MoE layer or ``with_aux``, the caches stacked
    over blocks, or None without ``return_cache``)."""
    axis = h.dim() - 3
    n = next(iter(stacked.values())).shape[axis]
    aux, caches = 0.0, []
    for i in range(n):
        bp = {k: v.select(axis, i) for k, v in stacked.items()}
        kw = dict(window=window, with_aux=with_aux, enc_out=enc_out,
                  causal=causal)
        if remat:
            h, a, c = checkpoint(block_apply, cfg, bp, h,
                                 use_reentrant=False, **kw)
        else:
            h, a, c = block_apply(cfg, bp, h, **kw)
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
    """One layer of one decode step; ``cache`` is the layer's (k/v or the
    MLA latent and rope key written in place; the SSM states replaced; a
    cross-attention's xk/xv only read). Returns (h, cache)."""
    hin = rms_norm(h, p["norm1"], cfg.norm_eps)
    cache = dict(cache)
    if kind["mixer"] == "attn" and cfg.mla is not None:
        y, ckv, kr, _ = mla_decode(cfg, subtree(p, "mixer/"), hin,
                                   cache["ckv"], cache["kr"], index,
                                   slot_pos=slot_pos, window=window)
        cache.update(ckv=ckv, kr=kr)
    elif kind["mixer"] == "attn":
        y, k, v, _ = attn_decode(cfg, subtree(p, "mixer/"), hin, cache["k"],
                                 cache["v"], index, slot_pos=slot_pos,
                                 window=window)
        cache.update(k=k, v=v)
    else:
        y, conv, state = ssm_decode(cfg, subtree(p, "mixer/"), hin,
                                    cache["conv"], cache["state"])
        cache.update(conv=conv, state=state)
    h = h + y
    if "norm_x" in p and "xk" in cache:
        hx = rms_norm(h, p["norm_x"], cfg.norm_eps)
        h = h + cross_attn_decode(cfg, subtree(p, "cross/"), hx,
                                  cache["xk"], cache["xv"])
    if kind["mlp"] != "none":
        h = h + _mlp(cfg, p, kind, h, with_aux=False)[0]
    return constrain(h, "dec"), cache


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
    (n_blocks, ...)) are updated in place — the attention k/v and the MLA
    latent written at the new position, the SSM conv and state leaves
    overwritten — and returned."""
    for i in range(cfg.n_blocks):
        bp = {k: v[i] for k, v in stacked.items()}
        bc = {k: v[i] for k, v in caches.items()}
        h, new = block_decode(cfg, bp, h, bc, index, slot_pos=slot_pos,
                              window=window)
        for k, v in new.items():
            if v is not bc[k]:
                caches[k][i].copy_(v)
    return h, caches
