"""Shared model building blocks: initializers, norms (the Mamba2 gated one
too), RoPE, the SwiGLU MLP, the cross-entropy and the SGD step.

Every function also takes a *stacked* cohort: weights with a leading
client axis (N, ...) applied to activations with the same leading axis,
client i's weights to client i's rows (``linear``, ``per_client``).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import batch_invariant as bi
from repro_torch.random import split, truncated_normal
from repro_torch.sharding.dtensor import reduced

_TRUNC = 3.0    # truncation at +-3 sigma, as the JAX package's initializers


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------- #
# Initialisation: the reference's draws (``repro_torch.random``), from a
# key on the device that draws
# ---------------------------------------------------------------------- #
def dense_init(key: torch.Tensor, shape, dtype=torch.float32,
               fan_in=None) -> torch.Tensor:
    """Truncated normal at +-3 sigma, sigma = 1/sqrt(fan_in), cast to
    ``dtype``: the reference's ``dense_init`` from the same key, drawn on
    the key's device."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return truncated_normal(key, -_TRUNC, _TRUNC, shape, scale=std,
                            dtype=dtype)


def embed_init(key: torch.Tensor, shape,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated normal at +-3 sigma, sigma = 0.02."""
    return truncated_normal(key, -_TRUNC, _TRUNC, shape, scale=0.02,
                            dtype=dtype)


def ones(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones(shape, dtype=dtype, device=device)


def zeros(shape, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------- #
# Flat parameter dicts: a nested module's leaves under "/"-joined keys
# ---------------------------------------------------------------------- #
def prefixed(prefix: str, params):
    """``params`` with every key under ``prefix``."""
    return {prefix + k: v for k, v in params.items()}


def subtree(params, prefix: str):
    """The leaves under ``prefix``, with the prefix taken off their keys."""
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------- #
# Stacked-cohort products
# ---------------------------------------------------------------------- #
def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, f); a stacked w (N, d, f) multiplies client i's
    rows x[i] (x (N, ..., d)) by its own w[i]. In the task plane on the
    card, the batch-invariant product (``models/batch_invariant.py``)."""
    if bi.on(x):
        return bi.linear(x, w)
    if w.dim() == 2:
        return x @ w
    n = w.shape[0]
    return (x.reshape(n, -1, x.shape[-1]) @ w).reshape(
        *x.shape[:-1], w.shape[-1])


def per_client(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A vector parameter (d,) as it is, or a stacked one (N, d) shaped
    (N, 1, ..., 1, d) to broadcast against client-major x (N, ..., d)."""
    if v.dim() == 1:
        return v
    return v.reshape(v.shape[0], *([1] * (x.dim() - 2)), v.shape[-1])


# ---------------------------------------------------------------------- #
# Norms (computed in float32, cast back)
# ---------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    if bi.on(x):
        return bi.rms_norm(x, per_client(scale, x), eps)
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * per_client(scale, x).float()).to(x.dtype)


def gated_rms_norm(x: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba2 output norm: RMSNorm(x * silu(z)), silu in float32."""
    return rms_norm(x * F.silu(z.float()).to(x.dtype), scale, eps)


# ---------------------------------------------------------------------- #
# RoPE
# ---------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies, float64 (cast to float32 where applied)."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=64)
def _rope_table(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    """``rope_frequencies`` as a float32 tensor on ``device``, made once:
    copying the host array to the card at every call would synchronise the
    host with the card at every attention layer of a decode step."""
    return torch.as_tensor(rope_frequencies(head_dim, theta),
                           dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, D); positions broadcastable to (..., S). Rotate-half
    layout: the first and second halves of D are the pair's two parts."""
    d = x.shape[-1]
    freqs = _rope_table(d, float(theta), x.device)
    ang = positions[..., None].to(torch.float32) * freqs    # (..., S, D/2)
    sin = torch.sin(ang)[..., None, :]                      # (..., S, 1, D/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- #
# MLP
# ---------------------------------------------------------------------- #
def swiglu_init(key: torch.Tensor, d_model: int, d_ff: int,
                dtype=torch.float32):
    """The three SwiGLU weights, drawn on the key's device."""
    k1, k2, k3 = split(key, 3)
    return {
        "wg": dense_init(k1, (d_model, d_ff), dtype),
        "wu": dense_init(k2, (d_model, d_ff), dtype),
        "wd": dense_init(k3, (d_ff, d_model), dtype, fan_in=d_ff),
    }


def swiglu_apply(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(linear(x, p["wg"])) * linear(x, p["wu"])
    return linear(h, p["wd"])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None,
                  keep: int = 0) -> torch.Tensor:
    """Mean next-token cross-entropy, float32; logits (..., V), labels
    int64. ``mask`` weights each position: sum(nll * w) / max(sum(w), 1).
    The first ``keep`` axes are kept (the client axis of a stacked
    cohort: one loss per client). In the task plane on the card the sums
    and the logsumexp are the batch-invariant kernels' and the mean a
    quotient by a count tensor (``models/batch_invariant.py``)."""
    if bi.on(logits):
        return bi.cross_entropy(logits, labels, mask, keep)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = reduced(torch.gather(logits, -1, labels.unsqueeze(-1))).squeeze(-1)
    nll = logz - ll
    dims = tuple(range(keep, nll.dim()))
    if mask is not None:
        return (nll * mask).sum(dims) / mask.sum(dims).clamp_min(1.0)
    return nll.mean(dims)


# ---------------------------------------------------------------------- #
# Training
# ---------------------------------------------------------------------- #
def sgd_step(params, loss_fn, lr: float):
    """p <- p - lr * grad(loss_fn)(p). ``loss_fn`` returns one loss per
    client; their sum is differentiated (a gradient of 1 seeded into every
    client's loss, the sum's own backward without running the sum), and
    since the clients' terms are disjoint each client's gradient is its
    own."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(p)
    grads = torch.autograd.grad(loss, list(p.values()),
                                torch.ones_like(loss))
    return {k: (v - lr * g).detach() for (k, v), g in zip(p.items(), grads)}
