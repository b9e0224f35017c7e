"""Multi-head latent attention (DeepSeek-V3, arXiv:2412.19437), the JAX
package's ``models/mla.py``.

The low-rank structure: a compressed KV latent ``c_kv`` (``kv_lora_rank``)
and a decoupled RoPE key (``qk_rope_head_dim``) shared by every head. The
full-sequence form (train / prefill) expands the latent into per-head keys
and values; decode uses the *absorbed* form (W_uk folded into the query,
W_uv applied after the attention), so the cache holds only the latent and
the rope key, kv_lora_rank + qk_rope_head_dim values a token.

Parameters are a flat dict: ``wdq`` (d, q_lora), ``q_norm``, ``wuq``
(q_lora, H·(nope + rope)), ``wdkv`` (d, kv_lora), ``kv_norm``, ``wkr`` (d,
rope), ``wuk`` (kv_lora, H·nope), ``wuv`` (kv_lora, H·v), ``wo`` (H·v, d).

Plain PyTorch, as the reference is plain jnp: MLA's head dims (q·k 192, v
128 at full width; the absorbed 576 / 512) are not the attention kernels'
shapes, and the reference never sends MLA to a Pallas kernel. The
full-sequence form computes its float32 logits one batch row at a time:
at DeepSeek's serving shape (8 prompts of 2,048 tokens, 128 heads) all of
them at once would take 17.2 GB, one row 2.1 GB; the arithmetic is the
same. A sharded step (``DTensor``s) computes each rank's rows at once.
The cache writes of a decode step go through
``sharding.dtensor.write_slot``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import NEG_INF, band_mask
from repro_torch.models.common import (apply_rope, dense_init, dtype_of,
                                       linear, ones, rms_norm)
from repro_torch.sharding.dtensor import (heads_ready, is_dtensor,
                                          merged_heads, write_slot)


def mla_init(generator: torch.Generator, cfg):
    """The MLA leaves, drawn on the generator's device in the reference's
    order."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    dt, dev = dtype_of(cfg), generator.device
    return {
        "wdq": dense_init(generator, (d, m.q_lora_rank), dt),
        "q_norm": ones((m.q_lora_rank,), dt, dev),
        "wuq": dense_init(generator, (m.q_lora_rank, h * qk_hd), dt),
        "wdkv": dense_init(generator, (d, m.kv_lora_rank), dt),
        "kv_norm": ones((m.kv_lora_rank,), dt, dev),
        "wkr": dense_init(generator, (d, m.qk_rope_head_dim), dt),
        "wuk": dense_init(generator, (m.kv_lora_rank, h * m.qk_nope_head_dim),
                          dt),
        "wuv": dense_init(generator, (m.kv_lora_rank, h * m.v_head_dim), dt),
        "wo": dense_init(generator, (h * m.v_head_dim, d), dt,
                         fan_in=h * m.v_head_dim),
    }


def _queries(cfg, p, x, positions):
    """x (B, S, d) -> (q_nope (B, S, H, nope), q_rope (B, S, H, rope),
    rotated)."""
    m = cfg.mla
    b, s, _ = x.shape
    cq = rms_norm(linear(x, p["wdq"]), p["q_norm"], cfg.norm_eps)
    q = heads_ready(linear(cq, p["wuq"]), cfg.n_heads).reshape(
        b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _latent(cfg, p, x, positions):
    """x (B, S, d) -> (c_kv (B, S, kv_lora), the rotated rope key (B, S,
    rope)): what the cache keeps."""
    ckv = rms_norm(linear(x, p["wdkv"]), p["kv_norm"], cfg.norm_eps)
    kr = apply_rope(linear(x, p["wkr"])[:, :, None, :], positions,
                    cfg.rope_theta)[:, :, 0]
    return ckv, kr


def _scale(m) -> float:
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def mla_apply(cfg, p, x, *, window=None, positions=None):
    """Full sequence (train / prefill), causal (and windowed with
    ``window``): x (B, S, d) -> (y (B, S, d), (c_kv, k_rope)), the latent
    expanded into per-head keys and values."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q_nope, q_rope = _queries(cfg, p, x, positions)
    ckv, k_rope = _latent(cfg, p, x, positions)
    k_nope = heads_ready(linear(ckv, p["wuk"]), h).reshape(
        b, s, h, m.qk_nope_head_dim)
    v = heads_ready(linear(ckv, p["wuv"]), h).reshape(b, s, h, m.v_head_dim)
    masked = ~band_mask(s, s, True, window, x.device)
    if is_dtensor(v):
        # a sharded step: each rank's batch rows at once (a row of a
        # batch-sharded DTensor is on one rank; selecting it would gather
        # the batch)
        logits = (torch.einsum("bshd,bthd->bhst", q_nope, k_nope)
                  + torch.einsum("bshd,btd->bhst", q_rope, k_rope))
        logits = (logits.float() * _scale(m)).masked_fill(masked, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhst,bthd->bshd", probs, v)
        return (linear(merged_heads(out.reshape(b, s, -1), h), p["wo"]),
                (ckv, k_rope))
    out = torch.empty((b, s, h, m.v_head_dim), dtype=v.dtype,
                      device=x.device)
    for i in range(b):             # one batch row's logits at a time
        logits = (torch.einsum("shd,thd->hst", q_nope[i], k_nope[i])
                  + torch.einsum("shd,td->hst", q_rope[i], k_rope[i]))
        logits = logits.float().mul_(_scale(m)).masked_fill_(masked, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        del logits
        out[i] = torch.einsum("hst,thd->shd", probs, v[i])
    return linear(out.reshape(b, s, -1), p["wo"]), (ckv, k_rope)


def mla_decode(cfg, p, x, cache_ckv, cache_kr, index: int, *, slot_pos=None,
               window=None):
    """The absorbed single-token decode over the compressed cache: x (B,
    1, d) at absolute position ``index`` (a host int) -> (y (B, 1, d),
    cache_ckv (B, C, kv_lora), cache_kr (B, C, rope), slot_pos).

    The new latent and rope key are written into the caches in place (and
    ``index`` into ``slot_pos`` on a ring), where the reference returns
    updated copies; the same tensors come back. The attention reads the
    valid positions only, a contiguous run of the cache as in
    ``attention.attn_decode`` (``[index - window + 1, index]`` on a
    linear cache, the first ``min(index + 1, C)`` slots of a ring), where
    the reference masks the rest to -1e30, whose probabilities are 0.
    """
    m = cfg.mla
    b = x.shape[0]
    h = cfg.n_heads
    pos = torch.full((b, 1), index, device=x.device)
    q_nope, q_rope = _queries(cfg, p, x, pos)                  # (B,1,H,*)
    ckv_new, kr_new = _latent(cfg, p, x, pos)                  # (B,1,*)
    c = cache_ckv.shape[1]
    slot = index % c if slot_pos is not None else index
    write_slot(cache_ckv, 1, slot, ckv_new[:, 0])
    write_slot(cache_kr, 1, slot, kr_new[:, 0])
    if slot_pos is not None:
        slot_pos[slot].fill_(index)
        lo, hi = 0, min(index + 1, c)
    else:
        hi = index + 1
        lo = max(0, hi - window) if window is not None else 0
    ckv, kr = cache_ckv[:, lo:hi], cache_kr[:, lo:hi]
    # absorb W_uk into the query: q_lat (B, 1, H, kv_lora)
    wuk = heads_ready(p["wuk"], h).reshape(m.kv_lora_rank, h,
                                           m.qk_nope_head_dim)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, wuk)
    logits = (torch.einsum("bshr,btr->bhst", q_lat, ckv)
              + torch.einsum("bshd,btd->bhst", q_rope, kr))
    probs = torch.softmax(logits.float() * _scale(m), dim=-1).to(x.dtype)
    out_lat = torch.einsum("bhst,btr->bshr", probs, ckv)       # (B,1,H,r)
    wuv = heads_ready(p["wuv"], h).reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bshr,rhd->bshd", out_lat, wuv).reshape(b, 1, -1)
    return linear(out, p["wo"]), cache_ckv, cache_kr, slot_pos
