"""GQA attention for full sequences (train / evaluation) with RoPE, optional
QKV bias, QK-norm and sliding window.

Parameters are a flat dict (``wq``, ``wk``, ``wv``, ``wo``; ``bq``/``bk``/
``bv`` with ``qkv_bias``, ``q_norm``/``k_norm`` with ``qk_norm``) in the
JAX package's layout, weights stored (in, out). Like every model function
of the port, ``attn_apply`` also takes a stacked cohort: params with a
leading client axis and activations (N, B, S, d).

Every attention forward goes through ``kernels.flash_attention`` (K3):
the hand-written CUDA kernel on a CUDA tensor, its plain version on a CPU
tensor. The JAX package sends only sequences of a multiple of 8 to its
Pallas kernel (a TPU tiling constraint); the port's kernel masks the
ragged edge, so every sequence length takes K3.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import band_mask, flash_attention
from repro_torch.models.common import (apply_rope, dense_init, dtype_of,
                                       linear, ones, per_client, rms_norm)


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
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * hd,), dtype=dt)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dt)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dt)
    if cfg.qk_norm:
        p["q_norm"] = ones((hd,), dt)
        p["k_norm"] = ones((hd,), dt)
    return p


def _project_qkv(cfg, p, x):
    """x (..., S, d) -> q (..., S, Hq, D), k/v (..., S, Hkv, D)."""
    lead, hd = x.shape[:-1], cfg.head_dim
    q, k, v = linear(x, p["wq"]), linear(x, p["wk"]), linear(x, p["wv"])
    if cfg.qkv_bias:
        q = q + per_client(p["bq"], q)
        k = k + per_client(p["bk"], k)
        v = v + per_client(p["bv"], v)
    q = q.reshape(*lead, cfg.n_heads, hd)
    k = k.reshape(*lead, cfg.n_kv_heads, hd)
    v = v.reshape(*lead, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def causal_window_mask(S: int, window: Optional[int], device=None):
    """(1, 1, 1, S, S) causal (+ optional sliding-window) mask, the JAX
    package's layout."""
    return band_mask(S, S, True, window, device)[None, None, None]


def attn_apply(cfg, p, x, *, window=None, positions=None):
    """x (..., S, d) -> (attention output (..., S, d), (k, v))."""
    S = x.shape[-2]
    q, k, v = _project_qkv(cfg, p, x)
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = _full_attention(cfg, q, k, v, window)
    return linear(out, p["wo"]), (k, v)


def _full_attention(cfg, q, k, v, window):
    """Causal attention through K3. q (..., S, Hq, D), k/v (..., T, Hkv,
    D) -> (..., S, Hq*D). The leading axes (a stacked cohort's clients and
    their batch) fold into the kernel's batch axis; the KV heads repeat
    G = Hq/Hkv times (``jnp.repeat``: each head G times in a row) so query
    head h reads KV head h // G, as the JAX package's GQA grouping does."""
    *lead, S, Hq, D = q.shape
    T, Hkv = k.shape[-3], k.shape[-2]
    q = q.reshape(-1, S, Hq, D)
    k = k.reshape(-1, T, Hkv, D)
    v = v.reshape(-1, T, Hkv, D)
    if Hq != Hkv:
        k = k.repeat_interleave(Hq // Hkv, dim=2)
        v = v.repeat_interleave(Hq // Hkv, dim=2)
    out = flash_attention(q.transpose(1, 2).contiguous(),
                          k.transpose(1, 2).contiguous(),
                          v.transpose(1, 2).contiguous(),
                          causal=True, window=window)
    return out.transpose(1, 2).reshape(*lead, S, Hq * D)
