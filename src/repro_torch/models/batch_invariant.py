"""The task plane's batch-invariant route: every float32 product and
reduction of the two federated models (``models/mlp.py``, ``lm_tiny``
through ``models/transformer.py``) on the card, forward and backward,
through the port's own kernels ``kernels/bi_gemm.py`` and
``kernels/bi_reduce.py``, so that a client's trained params, local metric
and evaluation units do not depend on how many clients or sweep rows
share the call. The loop oracle (one client a call) then equals the
vectorized engine (a stack of N) bit for bit, and a sweep its sequential
runs, as they do on the CPU.

Which calls take it: those made inside ``route()`` (the task plane's own
methods enter it, ``task_plane``) on a CUDA tensor — ``on(x)``. The model
code keeps its torch expressions as they were for every other call: the
CPU (where they are the plain versions, and every number stays what it
was), ``meta`` traces, and the zoo's serving and training, which never
enter the route.

On the route:
- a product (with the MLP's bias, ``affine``) is ``bi_gemm`` in an
  autograd Function whose backward launches ``bi_gemm`` for dX and dW
  and ``bi_reduce`` for the bias;
- a sum over trailing axes is ``bi_reduce`` (``sum_trailing``); a mean is
  that sum divided by a count tensor, never multiplied by a reciprocal
  (CUDA's mean and its quotient by a host scalar do that);
- a parameter broadcast over a client's rows (a norm scale, an
  attention bias) and the rms factor broadcast over d are ``expand``: a
  view forward, a ``bi_reduce`` sum backward, where autograd would run
  torch's own reduction;
- the cross-entropy's logsumexp and every argmax are ``bi_reduce``; the
  picked logit is a gather whose backward scatters one value a row;
- the embedding's gradient is a one-hot product through ``bi_gemm``,
  where autograd would accumulate with ``index_put_``;
- attention is K3's forward (``kernels/flash_attention.py``) in a
  Function of this module whose backward is the plain VJP of
  ``flash_attention_ref`` written out on ``bi_gemm`` and ``bi_reduce``
  (``invariant_vjp``).
Everything else on the path is elementwise, the same arithmetic a value
whatever the tensor's size. Where autograd records nothing (the
evaluations, a mask's sum) the kernels are called without a Function.

The route is chosen at the forward, on the caller's thread, and every
Function here launches the kernels in its backward whatever thread runs
it: on CUDA tensors autograd runs a backward on its device thread, where
``route()``'s thread-local flag is not set.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels.bi_gemm import bi_gemm
from repro_torch.kernels.bi_reduce import ARGMAX, LOGSUMEXP, SUM, bi_reduce
from repro_torch.kernels.flash_attention import (NEG_INF, band_mask,
                                                 flash_attention)

_state = threading.local()

# torch's products and reductions, each of whose order on CUDA torch
# picks by the call's shape: on the route none of them runs on a CUDA
# tensor (``chip_smoke.invariance_probe`` and the CPU tests read a routed
# step's operators against this set)
TORCH_SUMS = frozenset(f"aten.{n}" for n in (
    "mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "mv", "dot",
    "einsum", "_softmax", "_softmax_backward_data", "_log_softmax",
    "_log_softmax_backward_data", "sum", "mean", "logsumexp", "amax",
    "amin", "max", "min", "argmax", "argmin", "var", "std", "norm",
    "linalg_vector_norm", "cumsum", "prod", "index_put", "index_put_",
    "_index_put_impl_", "index_add", "index_add_", "scatter_add",
    "scatter_add_", "scatter_reduce", "embedding_dense_backward"))


def _active() -> bool:
    return getattr(_state, "active", False)


@contextlib.contextmanager
def route():
    """Send the task plane's products and reductions on CUDA tensors to
    the batch-invariant kernels for the duration of the block (this
    thread's)."""
    old = _active()
    _state.active = True
    try:
        yield
    finally:
        _state.active = old


def task_plane(fn):
    """Decorate a task-plane function: its body runs inside ``route()``."""
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        with route():
            return fn(*args, **kwargs)
    return inner


def on(x: torch.Tensor) -> bool:
    """Whether ``x``'s operation takes the kernels: inside ``route()`` and
    on the card."""
    return _active() and x.is_cuda


def _differentiable(*ts) -> bool:
    """Whether autograd records an operation on ``ts``: where it does not
    (the evaluations, a mask's sum) the route calls its kernel directly,
    without a Function's host time."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


# ---------------------------------------------------------------------- #
# Products
# ---------------------------------------------------------------------- #
def _fold(d: torch.Tensor, rows: int) -> torch.Tensor:
    """A gradient (batch, X, Y) of an operand of ``rows`` (1 or the batch)
    matrices: summed over the batch where one matrix was shared."""
    if d.shape[0] == rows:
        return d
    return bi_reduce(d.reshape(1, d.shape[0], -1)).reshape(1, *d.shape[1:])


def _affine(a, b, bias):
    out = bi_gemm(a, b)
    return out if bias is None else out.add_(bias)


class _Affine(torch.autograd.Function):
    """a (Ba, M, K) @ b (Bb, K, N) (+ a bias (Bc, 1, N) over the M rows)
    on ``bi_gemm``; dA = g @ bᵀ and dB = aᵀ @ g on ``bi_gemm`` too, the
    bias's gradient the sum of g over M on ``bi_reduce``."""

    @staticmethod
    def forward(ctx, a, b, bias):
        ctx.save_for_backward(a, b)
        ctx.bias_rows = None if bias is None else bias.shape[0]
        return _affine(a, b, bias)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = dbias = None
        if ctx.needs_input_grad[0]:
            da = _fold(bi_gemm(g, b.mT), a.shape[0])
        if ctx.needs_input_grad[1]:
            db = _fold(bi_gemm(a.mT, g), b.shape[0])
        if ctx.needs_input_grad[2]:
            dbias = _fold(bi_reduce(g).unsqueeze(1), ctx.bias_rows)
        return da, db, dbias


def _product(a, b, bias=None):
    if _differentiable(a, b, bias):
        return _Affine.apply(a, b, bias)
    return _affine(a, b, bias)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``models.common.linear`` on the kernels: x (..., K) @ w (K, F), or
    a stacked w (N, K, F) against client-major x (N, ..., K)."""
    if w.dim() == 2:
        a, b = x.reshape(1, -1, x.shape[-1]), w.unsqueeze(0)
    else:
        a, b = x.reshape(w.shape[0], -1, x.shape[-1]), w
    return _product(a, b).reshape(*x.shape[:-1], w.shape[-1])


def affine(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """``x @ w + b`` on the kernels for the MLP's layers: w (K, F) and b
    (F,) against x (..., K); a stacked w (N, K, F) and b (N, F) against x
    (N, B, K), or against x (U, K) shared by the N clients -> (N, U, F)."""
    if w.dim() == 2:
        a, bias = x.reshape(1, -1, x.shape[-1]), b.reshape(1, 1, -1)
        out = _product(a, w.unsqueeze(0), bias)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    bias = b.unsqueeze(1)
    if x.dim() == 2:
        return _product(x.unsqueeze(0), w, bias)
    out = _product(x.reshape(w.shape[0], -1, x.shape[-1]), w, bias)
    return out.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------- #
# Reductions
# ---------------------------------------------------------------------- #
def _sum_rmd(v_shape: Sequence[int], shape: Sequence[int]
             ) -> Tuple[int, int, int]:
    """(R, M, D) such that summing a (shape) gradient over M gives the
    broadcast operand's (v_shape): the broadcast axes must be one run."""
    v = (1,) * (len(shape) - len(v_shape)) + tuple(v_shape)
    wide = [i for i, (a, b) in enumerate(zip(v, shape)) if a == 1 and b > 1]
    if not wide:
        return math.prod(shape), 1, 1
    i, j = wide[0], wide[-1] + 1
    if any(v[k] != shape[k] for k in range(len(shape))
           if not i <= k < j) or any(v[k] != 1 for k in range(i, j)):
        raise ValueError(f"cannot sum {tuple(shape)} back to "
                         f"{tuple(v_shape)}: the broadcast axes are not "
                         "one run")
    return (math.prod(shape[:i]), math.prod(shape[i:j]),
            math.prod(shape[j:]))


class _Expand(torch.autograd.Function):
    """v.expand(shape); backward: the sum over the broadcast axes on
    ``bi_reduce``."""

    @staticmethod
    def forward(ctx, v, shape):
        ctx.v_shape = v.shape
        ctx.rmd = _sum_rmd(v.shape, shape)
        return v.expand(shape)

    @staticmethod
    def backward(ctx, g):
        r, m, d = ctx.rmd
        if m == 1:
            return g.reshape(ctx.v_shape), None
        return bi_reduce(g.reshape(r, m, d)).reshape(ctx.v_shape), None


def expand(v: torch.Tensor, shape) -> torch.Tensor:
    """``v`` broadcast to ``shape``, its gradient summed back on the
    kernel."""
    if not _differentiable(v):
        return v.expand(shape)
    return _Expand.apply(v, tuple(shape))


def _sum(x: torch.Tensor, keep: int) -> torch.Tensor:
    lead = x.shape[:keep]
    return bi_reduce(x.reshape(math.prod(lead), -1, 1)).reshape(lead)


class _SumTrailing(torch.autograd.Function):
    """The sum over every axis from ``keep`` on; backward: expand."""

    @staticmethod
    def forward(ctx, x, keep):
        ctx.shape = x.shape
        return _sum(x, keep)

    @staticmethod
    def backward(ctx, g):
        pad = (1,) * (len(ctx.shape) - g.dim())
        return g.reshape(*g.shape, *pad).expand(ctx.shape), None


def sum_trailing(x: torch.Tensor, keep: int) -> torch.Tensor:
    """``x.sum(dims)`` over the axes from ``keep`` on, on the kernel."""
    if not _differentiable(x):
        return _sum(x, keep)
    return _SumTrailing.apply(x, keep)


@functools.lru_cache(maxsize=None)
def _count(n: int, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):     # a quotient's backward saves it
        return torch.full((), float(n), dtype=torch.float32, device=device)


def count(x: torch.Tensor, keep: int) -> torch.Tensor:
    """The number of elements ``sum_trailing(x, keep)`` adds, as a float32
    tensor on x's device (a quotient by it is IEEE's), made once a count
    and device."""
    return _count(math.prod(x.shape[keep:]), x.device)


def mean(x: torch.Tensor, keep: int) -> torch.Tensor:
    """The mean over the axes from ``keep`` on; on the route their sum
    divided by a count tensor, else ``x.mean``."""
    if not on(x):
        return x.mean(tuple(range(keep, x.dim())))
    return sum_trailing(x, keep) / count(x, keep)


def masked_mean(x: torch.Tensor, w: torch.Tensor, keep: int
                ) -> torch.Tensor:
    """sum(x * w) / max(sum(w), 1) over the axes from ``keep`` on, the
    sums on the kernel on the route."""
    if not on(x):
        dims = tuple(range(keep, x.dim()))
        return (x * w).sum(dims) / w.sum(dims).clamp_min(1.0)
    return sum_trailing(x * w, keep) / sum_trailing(w, keep).clamp_min(1.0)


class _NLL(torch.autograd.Function):
    """logsumexp(x) - x[..., label] over the last axis, the logsumexp on
    ``bi_reduce`` and the picked logit a gather; backward
    g · exp(x - logsumexp) with g taken off at each row's label (a gather
    and a scatter of one value a row: no atomics)."""

    @staticmethod
    def forward(ctx, x, labels):
        lse = bi_reduce(x.reshape(-1, x.shape[-1], 1),
                        LOGSUMEXP).reshape(x.shape[:-1])
        ctx.save_for_backward(x, labels, lse)
        return lse - torch.gather(x, -1, labels.unsqueeze(-1)).squeeze(-1)

    @staticmethod
    def backward(ctx, g):
        x, labels, lse = ctx.saved_tensors
        g, at = g.unsqueeze(-1), labels.unsqueeze(-1)
        grad = g * torch.exp(x - lse.unsqueeze(-1))
        return grad.scatter_(-1, at, grad.gather(-1, at) - g), None


def nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The per-row cross-entropy logsumexp(logits) - logits[label]."""
    return _NLL.apply(logits, labels)


def argmax(x: torch.Tensor) -> torch.Tensor:
    """``torch.argmax(x, -1)``, on the route on the kernel (the first of
    equal maxima, as torch's)."""
    if not on(x):
        return torch.argmax(x, -1)
    return bi_reduce(x.reshape(-1, x.shape[-1], 1),
                     ARGMAX).reshape(x.shape[:-1])


# ---------------------------------------------------------------------- #
# The models' compound operations
# ---------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    """``models.common.rms_norm`` on the kernels; ``scale`` already shaped
    to broadcast (``per_client``)."""
    xf = x.float()
    var = mean(xf.square(), xf.dim() - 1).unsqueeze(-1)
    y = xf * expand(torch.rsqrt(var + eps), xf.shape)
    return (y * expand(scale.float(), y.shape)).to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor], keep: int) -> torch.Tensor:
    """``models.common.cross_entropy`` on the kernels."""
    per_row = nll(logits.float(), labels)
    if mask is not None:
        return masked_mean(per_row, mask, keep)
    return mean(per_row, keep)


def _lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    if table.dim() == 2:
        return table[tokens]
    n = table.shape[0]
    clients = torch.arange(n, device=table.device)
    return table[clients.view(n, *([1] * (tokens.dim() - 1))), tokens]


class _Embed(torch.autograd.Function):
    """table[tokens] (a table (V, d), or stacked (N, V, d) read by client
    i's tokens (N, ...)); backward: onehot(tokens)ᵀ @ g on ``bi_gemm``."""

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.shape = table.shape
        return _lookup(table, tokens)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        n = ctx.shape[0] if len(ctx.shape) == 3 else 1
        vocab = torch.arange(ctx.shape[-2], device=g.device)
        onehot = (tokens.reshape(n, -1, 1) == vocab).to(g.dtype)
        grad = bi_gemm(onehot.mT, g.reshape(n, -1, g.shape[-1]))
        return grad.reshape(ctx.shape), None


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    if not _differentiable(table):
        return _lookup(table, tokens)
    return _Embed.apply(table, tokens)


@functools.lru_cache(maxsize=None)
def _outside_band(s: int, t: int, causal: bool, window: Optional[int],
                  device: torch.device) -> torch.Tensor:
    """~``band_mask``, made once a shape and device."""
    with torch.inference_mode(False):
        return ~band_mask(s, t, causal, window, device)


def invariant_vjp(q, k, v, g, causal: bool, window: Optional[int],
                  scale: float):
    """(dq, dk, dv) of ``flash_attention_ref(q, k, v)`` against g, q/g
    (B, H, S, D), k/v (B, Hkv, T, D) float32, on the kernels: the scores
    recomputed, p = exp(s - logsumexp(s)), dp = g vᵀ, ds = p (dp -
    rowsum(p dp)) · scale, dq = ds k, dk = dsᵀ q, dv = pᵀ g, each of a
    query head's products one matrix of a ``bi_gemm`` batch over (B, H),
    every row's sum one chain of ``bi_reduce``; dk and dv summed over the
    G query heads of a KV head on ``bi_reduce``. A client's gradient so
    does not depend on how many clients share B."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    grp = h // hkv
    if grp > 1:
        k = k.repeat_interleave(grp, dim=1)
        v = v.repeat_interleave(grp, dim=1)
    q3, g3 = q.reshape(b * h, s, d), g.reshape(b * h, s, d)
    k3, v3 = k.reshape(b * h, t, d), v.reshape(b * h, t, d)
    sc = bi_gemm(q3, k3.mT) * scale
    if causal or window is not None:
        sc = sc.masked_fill(_outside_band(s, t, causal, window, q.device),
                            NEG_INF)
    lse = bi_reduce(sc.reshape(-1, t, 1), LOGSUMEXP).reshape(b * h, s, 1)
    p = torch.exp(sc - lse)
    dp = bi_gemm(g3, v3.mT)
    rows = bi_reduce((p * dp).reshape(-1, t, 1), SUM).reshape(b * h, s, 1)
    ds = p * (dp - rows) * scale
    dq = bi_gemm(ds, k3).reshape(b, h, s, d)
    dk, dv = bi_gemm(ds.mT, q3), bi_gemm(p.mT, g3)
    if grp > 1:
        dk, dv = (bi_reduce(x.reshape(b * hkv, grp, t * d)) for x in (dk, dv))
    return dq, dk.reshape(b, hkv, t, d), dv.reshape(b, hkv, t, d)


class _Attention(torch.autograd.Function):
    """K3's forward; backward ``invariant_vjp``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale)
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)

    @staticmethod
    def backward(ctx, g):
        return (*invariant_vjp(*ctx.saved_tensors, g, *ctx.args), None,
                None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None
              ) -> torch.Tensor:
    """``kernels.flash_attention`` (K3) for the route: q (B, H, S, D),
    k/v (B, Hkv, T, D) float32; its gradient ``invariant_vjp``."""
    if not _differentiable(q, k, v):
        return flash_attention(q, k, v, causal=causal, window=window)
    return _Attention.apply(q, k, v, causal, window, q.shape[3] ** -0.5)
