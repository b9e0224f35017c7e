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

from repro_torch.sharding.dtensor import reduced

_TRUNC = 3.0    # truncation at +-3 sigma, as the JAX package's initializers


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------- #
# Initialisation
# ---------------------------------------------------------------------- #
class MetaGenerator:
    """Stands in for a ``torch.Generator`` where parameters are built on
    the ``meta`` device (shapes and dtypes, no storage): torch has no
    generator there, and nothing is drawn."""
    device = torch.device("meta")


def _truncated_normal(generator: torch.Generator, shape) -> torch.Tensor:
    """Standard normal truncated at +-3, float32, by the inverse CDF of one
    float32 uniform draw from ``generator``, on the generator's device:
    unlike ``torch.nn.init.trunc_normal_``, whose sampling algorithm has
    changed between torch releases, this gives the same values on every
    torch version for the same seed and generator device (a CPU generator
    draws on the host, a CUDA one on its card, where a 22 B-parameter model
    can be drawn at all). A ``MetaGenerator`` gives a ``meta`` tensor of
    the shape, drawing nothing."""
    if generator.device.type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    cdf = lambda z: 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
    u = torch.empty(shape, dtype=torch.float32,
                    device=generator.device).uniform_(
        2.0 * cdf(-_TRUNC) - 1.0, 2.0 * cdf(_TRUNC) - 1.0,
        generator=generator)
    # in place: a DeepSeek expert weight is 15 GB as one float32 draw
    return u.erfinv_().mul_(math.sqrt(2.0)).clamp_(-_TRUNC, _TRUNC)


def dense_init(generator: torch.Generator, shape, dtype=torch.float32,
               fan_in=None) -> torch.Tensor:
    """Truncated normal at +-3 sigma, sigma = 1/sqrt(fan_in), cast to
    ``dtype``."""
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    return _truncated_normal(generator, shape).mul_(std).to(dtype)


def embed_init(generator: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated normal at +-3 sigma, sigma = 0.02."""
    return _truncated_normal(generator, shape).mul_(0.02).to(dtype)


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
    rows x[i] (x (N, ..., d)) by its own w[i]."""
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
def swiglu_init(generator: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32):
    """The three SwiGLU weights, drawn on the generator's device."""
    return {
        "wg": dense_init(generator, (d_model, d_ff), dtype),
        "wu": dense_init(generator, (d_model, d_ff), dtype),
        "wd": dense_init(generator, (d_ff, d_model), dtype, fan_in=d_ff),
    }


def swiglu_apply(p, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(linear(x, p["wg"])) * linear(x, p["wu"])
    return linear(h, p["wd"])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None,
                  keep: int = 0) -> torch.Tensor:
    """Mean next-token cross-entropy, float32; logits (..., V), labels
    int64. ``mask`` weights each position: sum(nll * w) / max(sum(w), 1).
    The first ``keep`` axes are kept (the client axis of a stacked
    cohort: one loss per client)."""
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
    client; their sum is differentiated, and since the clients' terms are
    disjoint each client's gradient is its own."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = torch.autograd.grad(loss_fn(p).sum(), list(p.values()))
    return {k: (v - lr * g).detach() for (k, v), g in zip(p.items(), grads)}
