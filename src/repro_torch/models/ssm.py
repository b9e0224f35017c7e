"""Mamba2 / SSD (state-space duality) blocks [arXiv:2405.21060].

The full-sequence path (``ssm_apply``, train and prefill) runs the SSD
scan through ``kernels.ssd_scan`` (K6) at the config's
``ssm.compute_dtype``: the hand-written CUDA kernel on a CUDA tensor, its
plain version (the sequential recurrence, or the chunked form with bf16
compute) on a CPU tensor; its gradient is the VJP of ``ssd_chunked``, the JAX package's
chunked training formula in plain PyTorch, which lives beside the kernel
(``kernels/ssd_scan.py``) and is importable from here under its
reference name. Decode (``ssm_decode``) is the O(1) state recurrence
in plain PyTorch (no TPU kernel covers it).

Parameters are a flat dict in the JAX package's layout (``in_proj``,
``conv_w``, ``conv_b``, ``A_log``, ``D``, ``dt_bias``, ``norm``,
``out_proj``). On ``DTensor``s the split of the channels into heads and
groups, and the merge back, go through ``sharding.dtensor``'s
``heads_ready`` and ``merged_heads``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan  # noqa: F401
from repro_torch.models.common import (dense_init, dtype_of, gated_rms_norm,
                                       linear, ones, zeros)
from repro_torch.sharding.dtensor import (heads_ready, merged_heads,
                                          zero_pad)


def ssm_init(generator: torch.Generator, cfg, d_model=None):
    s = cfg.ssm
    d = d_model or cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    dt, dev = dtype_of(cfg), generator.device
    # dt bias initialised so softplus(dt_bias) spans [dt_min, dt_max]: the
    # reference's own host draw, the same for every layer and seed
    u = np.random.RandomState(0).uniform(size=(nh,))
    dt0 = np.exp(u * (np.log(s.dt_max) - np.log(s.dt_min)) + np.log(s.dt_min))
    dt_bias = dt0 + np.log(-np.expm1(-dt0))
    return {
        "in_proj": dense_init(
            generator, (d, 2 * d_in + 2 * s.n_groups * s.d_state + nh), dt),
        "conv_w": dense_init(generator, (s.conv_kernel, conv_ch), dt,
                             fan_in=s.conv_kernel),
        "conv_b": zeros((conv_ch,), dt, dev),
        "A_log": zeros((nh,), torch.float32, dev),        # A = -exp(0) = -1
        "D": ones((nh,), torch.float32, dev),
        "dt_bias": torch.tensor(dt_bias, dtype=torch.float32, device=dev),
        "norm": ones((d_in,), dt, dev),
        "out_proj": dense_init(generator, (d_in, d), dt, fan_in=d_in),
    }


def _split_proj(cfg, p, x):
    s = cfg.ssm
    d_in = s.expand * p["out_proj"].shape[1]
    nh = d_in // s.head_dim
    gn = s.n_groups * s.d_state
    # on a DTensor the split below cuts across the projection's column
    # shards: it is gathered here, whole, so that its gradient comes back
    # in the projection's column split
    zxbcdt = heads_ready(linear(x, p["in_proj"]), 1)
    z, xbc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * gn, nh], dim=-1)
    return z, xbc, dt, d_in, nh, gn


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over axis 1, then silu. xbc (B,L,ch); w
    (K,ch): the JAX package's sum of K shifted products, in its order."""
    k, length = w.shape[0], xbc.shape[1]
    pad = zero_pad(xbc, 1, k - 1, 0)
    out = pad[:, 0:length] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + length] * w[i]
    return F.silu(out + b)


def _heads(cfg, xbc, dt, p, d_in, nh, gn):
    """Split the convolved channels into x (B,L,H,P) and the grouped B/C
    (B,L,G,N) — views, not repeated to H heads: K6 reads a head's group
    itself — and dt = softplus(dt + dt_bias) (B,L,H) and A = -exp(A_log)
    (H,) in float32."""
    s = cfg.ssm
    b, length = xbc.shape[:2]
    x_, B_, C_ = torch.split(xbc, [d_in, gn, gn], dim=-1)
    x_ = heads_ready(x_, nh).unflatten(-1, (nh, s.head_dim))
    B_ = heads_ready(B_, s.n_groups).unflatten(-1, (s.n_groups, s.d_state))
    C_ = heads_ready(C_, s.n_groups).unflatten(-1, (s.n_groups, s.d_state))
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    return x_, B_, C_, dt, A


def ssm_apply(cfg, p, x, *, initial_state=None):
    """Full-sequence Mamba2 block, the SSD through K6. x (B,L,d) -> (y,
    (conv_state (B,K-1,ch) pre-activation, ssm_state (B,H,N,P) float32))."""
    s = cfg.ssm
    z, xbc, dt, d_in, nh, gn = _split_proj(cfg, p, x)
    conv_state = xbc[:, -(s.conv_kernel - 1):, :]
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    x_, B_, C_, dtf, A = _heads(cfg, xbc, dt, p, d_in, nh, gn)
    y, state = ssd_scan(x_, dtf, A, B_, C_, chunk=s.chunk,
                        initial_state=initial_state,
                        compute_dtype=s.compute_dtype)
    y = y + (p["D"][:, None] * x_.float()).to(y.dtype)
    y = merged_heads(y.reshape(*x.shape[:2], d_in), nh)
    y = gated_rms_norm(y, z, p["norm"], cfg.norm_eps)
    return linear(y, p["out_proj"]), (conv_state, state)


def ssm_decode(cfg, p, x, conv_state, ssm_state):
    """One-token recurrence. x (B,1,d); conv_state (B,K-1,ch); ssm_state
    (B,H,N,P) float32 -> (y, conv_state, ssm_state), new tensors."""
    z, xbc, dt, d_in, nh, gn = _split_proj(cfg, p, x)
    window = torch.cat([conv_state, xbc], dim=1)                 # (B,K,ch)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xbc1 = F.silu(conv_out)[:, None, :]
    x_, B_, C_, dtf, A = _heads(cfg, xbc1, dt, p, d_in, nh, gn)
    rep = nh // cfg.ssm.n_groups
    bh = B_[:, 0].repeat_interleave(rep, dim=1)                  # (B,H,N)
    ch = C_[:, 0].repeat_interleave(rep, dim=1)
    x1, dt1 = x_[:, 0], dtf[:, 0]
    decay = torch.exp(dt1 * A)                                   # (B,H)
    xdt = (x1 * dt1[..., None]).float()
    upd = torch.einsum("bhn,bhp->bhnp", bh.float(), xdt)
    new_state = ssm_state * decay[:, :, None, None] + upd
    y = torch.einsum("bhn,bhnp->bhp", ch.float(), new_state)
    y = y + p["D"][:, None] * x1.float()
    y = y.reshape(x.shape[0], 1, d_in).to(x.dtype)
    y = gated_rms_norm(y, z, p["norm"], cfg.norm_eps)
    return linear(y, p["out_proj"]), window[:, 1:], new_state
