"""GQA attention (train / evaluation / prefill / decode) with RoPE, optional
QKV bias, QK-norm, sliding window and ring-buffer decode caches; the
encoder's bidirectional self-attention and the decoder's cross-attention
of the encoder-decoder.

Parameters are a flat dict (``wq``, ``wk``, ``wv``, ``wo``; ``bq``/``bk``/
``bv`` with ``qkv_bias``, ``q_norm``/``k_norm`` with ``qk_norm``) in the
JAX package's layout, weights stored (in, out). Like every model function
of the port, ``attn_apply`` also takes a stacked cohort: params with a
leading client axis and activations (N, B, S, d).

Every attention forward goes through ``kernels.flash_attention`` (K3):
the hand-written CUDA kernel on a CUDA tensor, its plain version on a CPU
tensor. The JAX package sends only causal sequences of a multiple of 8 to
its Pallas kernel (a TPU tiling constraint) and computes the encoder's
attention and the cross-attention with its plain ``sdpa``; the port's
kernel masks the ragged edge and takes ``causal=False`` (the same function
without a mask), so every sequence length and both of those take K3.
Every decode step's attention, the cross-attention over the encoder's
cached keys and values included, goes through ``kernels.decode_attention``
(K4) the same way. ``sdpa`` is the JAX package's plain masked attention
with GQA grouping, kept for the tests.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import NEG_INF, decode_attention
from repro_torch.kernels.flash_attention import band_mask, flash_attention
from repro_torch.models.common import (apply_rope, dense_init, dtype_of,
                                       linear, ones, per_client, rms_norm,
                                       zeros)
from repro_torch.sharding.dtensor import (heads_ready, merged_heads,
                                          write_slot)


def attn_init(generator: torch.Generator, cfg, d_model=None):
    d = d_model or cfg.d_model
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    dt = dtype_of(cfg)
    p = {
        "wq": dense_init(generator, (d, hq * hd), dt),
        "wk": dense_init(generator, (d, hkv * hd), dt),
        "wv": dense_init(generator, (d, hkv * hd), dt),
        "wo": dense_init(generator, (hq * hd, d), dt, fan_in=hq * hd),
    }
    dev = generator.device
    if cfg.qkv_bias:
        p["bq"] = zeros((hq * hd,), dt, dev)
        p["bk"] = zeros((hkv * hd,), dt, dev)
        p["bv"] = zeros((hkv * hd,), dt, dev)
    if cfg.qk_norm:
        p["q_norm"] = ones((hd,), dt, dev)
        p["k_norm"] = ones((hd,), dt, dev)
    return p


def _project_qkv(cfg, p, x):
    """x (..., S, d) -> q (..., S, Hq, D), k/v (..., S, Hkv, D)."""
    lead, hd = x.shape[:-1], cfg.head_dim
    q, k, v = linear(x, p["wq"]), linear(x, p["wk"]), linear(x, p["wv"])
    if cfg.qkv_bias:
        q = q + per_client(p["bq"], q)
        k = k + per_client(p["bk"], k)
        v = v + per_client(p["bv"], v)
    q = heads_ready(q, cfg.n_heads).reshape(*lead, cfg.n_heads, hd)
    k = heads_ready(k, cfg.n_kv_heads).reshape(*lead, cfg.n_kv_heads, hd)
    v = heads_ready(v, cfg.n_kv_heads).reshape(*lead, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def sdpa(q, k, v, mask, scale: Optional[float] = None):
    """Plain masked attention with GQA grouping: q (B,S,Hq,D), k/v
    (B,T,Hkv,D), mask (bool) broadcastable to (B,Hkv,G,S,T) -> (B,S,Hq*D).
    Query head h reads KV head h // G (G = Hq/Hkv); float32 logits, masked
    logits -1e30, the probabilities cast to ``v.dtype``."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, s, hkv, hq // hkv, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, hq * d)


def causal_window_mask(S: int, window: Optional[int], device=None):
    """(1, 1, 1, S, S) causal (+ optional sliding-window) mask, the JAX
    package's layout."""
    return band_mask(S, S, True, window, device)[None, None, None]


def attn_apply(cfg, p, x, *, window=None, positions=None, causal=True):
    """x (..., S, d) -> (attention output (..., S, d), (k, v)); causal, or
    bidirectional with ``causal=False`` (the encoder's self-attention,
    the JAX package's ``encdec._encode`` with its all-true mask)."""
    S = x.shape[-2]
    q, k, v = _project_qkv(cfg, p, x)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _full_attention(q, k, v, window, causal)
    return linear(out, p["wo"]), (k, v)


def _full_attention(q, k, v, window, causal=True):
    """Attention through K3. q (..., S, Hq, D), k/v (..., T, Hkv, D) ->
    (..., S, Hq*D). The leading axes (a stacked cohort's clients and their
    batch) fold into the kernel's batch axis. K3 takes the Hkv KV heads as
    they are and reads KV head h // G for query head h (G = Hq/Hkv), as
    the JAX package's GQA grouping (``jnp.repeat``) does; the three
    transposes to its (B, H, S, D) layout are the only copies."""
    *lead, S, Hq, D = q.shape
    T, Hkv = k.shape[-3], k.shape[-2]
    q = q.reshape(-1, S, Hq, D)
    k = k.reshape(-1, T, Hkv, D)
    v = v.reshape(-1, T, Hkv, D)
    out = flash_attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(),
                          causal=causal, window=window)
    return merged_heads(out.transpose(1, 2).reshape(*lead, S, Hq * D), Hq)


def _cross_queries(cfg, p, x):
    """x (B, S, d) -> q (B, S, Hq, D): no bias and no RoPE, as in the
    reference's cross-attention."""
    q = heads_ready(linear(x, p["wq"]), cfg.n_heads).reshape(
        *x.shape[:-1], cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return q


def cross_attn_apply(cfg, p, x, kv_cache):
    """The decoder's cross-attention over a whole target sequence: x (B,
    S, d), kv_cache = the encoder's (k, v), each (B, S_src, Hkv, D), from
    ``encoder_kv`` -> (B, S, d). No mask: K3 with ``causal=False``, S and
    S_src in either order."""
    k, v = kv_cache
    out = _full_attention(_cross_queries(cfg, p, x), k, v, None,
                          causal=False)
    return linear(out, p["wo"])


def cross_attn_decode(cfg, p, x, xk, xv):
    """The cross-attention of one decode step: x (B, 1, d) over the
    encoder's cached xk/xv (B, S_src, Hkv, D), every position valid ->
    (B, 1, d); K4 with ``length = S_src``."""
    q = _cross_queries(cfg, p, x)
    out = decode_attention(q[:, 0], xk, xv, xk.shape[1])
    return linear(out.reshape(x.shape[0], 1, -1), p["wo"])


def encoder_kv(cfg, p, enc_out):
    """The cross-attention's keys and values from the encoder's output
    (B, S_src, d): (k, v), each (B, S_src, Hkv, D); no bias and no RoPE,
    as in the reference."""
    lead, hd = enc_out.shape[:-1], cfg.head_dim
    k = heads_ready(linear(enc_out, p["wk"]), cfg.n_kv_heads).reshape(
        *lead, cfg.n_kv_heads, hd)
    v = heads_ready(linear(enc_out, p["wv"]), cfg.n_kv_heads).reshape(
        *lead, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


def attn_decode(cfg, p, x, cache_k, cache_v, index: int, *, slot_pos=None,
                window=None):
    """One decode step: x (B,1,d) at absolute position ``index`` (a host
    int) -> (y (B,1,d), cache_k, cache_v, slot_pos).

    cache_k/v (B,C,Hkv,D): a linear cache (``slot_pos`` None, C the
    sequence capacity) or a ring buffer of the window (``slot_pos`` (C,)
    the absolute position of each slot, -1 when empty). Keys are stored
    rotated. The new key and value are written into the caches in place
    (and ``index`` into ``slot_pos``), where the JAX package returns
    updated copies; the same tensors come back.

    The attention is K4 over the valid positions, which are a contiguous
    run of the cache: on a linear cache ``[index - window + 1, index]``
    (from 0 without a window), passed as a view; on a ring the slots fill
    in order, so the valid ones (``slot_pos >= 0``) are the prefix of
    ``min(index + 1, C)`` slots, and softmax does not depend on the order
    of its keys. Both lengths are host ints: nothing synchronises.
    """
    b = x.shape[0]
    q, k, v = _project_qkv(cfg, p, x)                       # (B,1,H*,D)
    pos = torch.full((b, 1), index, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    c = cache_k.shape[1]
    slot = index % c if slot_pos is not None else index
    write_slot(cache_k, 1, slot, k[:, 0])
    write_slot(cache_v, 1, slot, v[:, 0])
    if slot_pos is not None:
        slot_pos[slot].fill_(index)
        lo, hi = 0, min(index + 1, c)
    else:
        hi = index + 1
        lo = max(0, hi - window) if window is not None else 0
    out = decode_attention(q[:, 0], cache_k[:, lo:hi], cache_v[:, lo:hi],
                           hi - lo)
    return (linear(out.reshape(b, 1, -1), p["wo"]), cache_k, cache_v,
            slot_pos)
