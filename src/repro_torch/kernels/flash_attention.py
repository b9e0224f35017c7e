"""Flash attention (causal, sliding-window or bidirectional), online softmax:

    o = softmax(scale * q k^T + mask) v

q (B,H,S,D), k/v (B,Hkv,T,D) -> (B,H,S,D), H a multiple of Hkv: query
head h reads KV head h // (H/Hkv), the grouping of ``jnp.repeat`` in the
JAX package's attention (Hkv == H is the TPU kernel's own signature).
Queries are right-aligned (query i sits at key position i + T - S). A key
j is masked when ``causal`` and j > i + T - S, or when ``window`` is given
and (i + T - S) - j >= window — the window applies with or without
``causal``, as in the TPU kernel (the JAX package's oracle applies it only
under ``causal``). A masked logit is -1e30. With a mask, S <= T (a query
past the keys' end would see none); without one (``causal=False``, no
window: the encoder's and the cross-attention) S and T are free, as in the
TPU kernel, which takes any S and T.

``flash_attention`` launches the hand-written Hopper kernel
``csrc/flash_attention.cu`` on CUDA tensors and runs the plain PyTorch
version ``flash_attention_ref`` on CPU tensors; there is no other path. It
replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``_flash_kernel`` / ``flash_attention``) and is differentiable as the
JAX package's ``ops.flash_attention`` is: the kernel is the forward, the
backward is the VJP of the plain version, recomputed (the TPU kernel has
no backward kernel either); dk and dv come back (B,Hkv,T,D), each KV
head's gradient summed over the query heads that read it.

bfloat16 runs on the tensor cores (``mma.sync``, float32 accumulators and
softmax, the probabilities rounded to bf16 before the second product, as
the plain version rounds them to v's type); float32 on the CUDA cores
(never TF32). The kernel reads each KV head in place for its G query
heads, so grouped-query attention moves no repeated K or V.

Both routes are the operator ``torch.ops.repro_torch.flash_attention``
(``kernels/oplib.py``), whose fake implementation serves ``meta`` tensors
and whose cost is ``cost``; the backward, plain PyTorch, is counted op by
op (``backward_cost`` is its bound).

Bound on the card: memory at the LM task's shapes (S = T = 32, D = 16):
q, k, v and o each move once, 4·B·H·S·D·bytes — 1.25 us at the training
shape (B = 128, H = 4, f32), 63 us at the evaluation shape (B = 6,400).
Operations at the serving prefill (S = T = 2,048, D = 128, bf16).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import build, oplib
from repro_torch.sharding.dtensor import is_dtensor, local_vjp

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)    # the kernel's instantiations
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D (B, H, S|T, D)")
    b, h, s, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match")
    if h % k.shape[1]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[1]} KV heads")
    if s < 1 or k.shape[2] < 1:
        raise ValueError(f"need S, T >= 1, got S = {s}, T = {k.shape[2]}")
    if s > k.shape[2] and (causal or window is not None):
        raise ValueError(f"a causal or windowed mask needs S <= T, got "
                         f"S = {s}, T = {k.shape[2]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def band_mask(s: int, t: int, causal: bool, window: Optional[int],
              device=None) -> torch.Tensor:
    """(S, T) bool: True where query i may attend to key j."""
    qi = torch.arange(s, device=device)[:, None] + (t - s)
    kj = torch.arange(t, device=device)[None, :]
    m = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        m &= kj <= qi
    if window is not None:
        m &= (qi - kj) < window
    return m


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version: the KV heads repeated to H, float32 logits,
    the -1e30 mask, softmax, the probabilities cast to ``v.dtype`` before
    the second product (as ``repro.kernels.ref.flash_attention_ref``)."""
    _check(q, k, v, causal, window)
    s, t, d = q.shape[2], k.shape[2], q.shape[3]
    g = q.shape[1] // k.shape[1]
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    scale = scale if scale is not None else d ** -0.5
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if causal or window is not None:
        logits = logits.masked_fill(
            ~band_mask(s, t, causal, window, q.device), NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype), v)


@functools.cache
def _launchers():
    """{dtype: C launcher} of the built kernel, argument types declared."""
    lib = build.load("flash_attention")
    fns = {torch.float32: lib.flash_attention_f32,
           torch.bfloat16: lib.flash_attention_bf16}
    for fn in fns.values():
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def _kernel(q, k, v, causal: bool, window: Optional[int],
            scale: float) -> torch.Tensor:
    """One launch of the CUDA kernel; raises on what it does not take."""
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if q.dtype == torch.bfloat16 and any(x.data_ptr() % 16
                                         for x in (q, k, v)):
        raise ValueError("bfloat16 q, k, v must start on a 16-byte "
                         "boundary")
    b, h, s, d = q.shape
    out = torch.empty_like(q)
    fn = _launchers()[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, h, k.shape[1], s, k.shape[2], d, int(causal),
                 window or 0, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError_t {err}")
    flash_attention.launches += 1
    return out


def band_pairs(s: int, t: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs ``band_mask(s, t, causal, window)`` keeps,
    counted per query without making the (S, T) mask."""
    qi = torch.arange(s, dtype=torch.int64) + (t - s)
    hi = qi.clamp(max=t - 1) if causal else torch.full_like(qi, t - 1)
    lo = (qi - window + 1).clamp(min=0) if window is not None else 0
    return int((hi - lo + 1).clamp(min=0).sum())


def cost(b: int, h: int, s: int, t: int, d: int, causal: bool,
         window: Optional[int], dtype: torch.dtype, hkv: Optional[int] = None):
    """(flops, bytes) of attention: 4·D flops for every (query head, key)
    pair inside the causal/window band; q read and o written once (H
    heads), k and v read once (their Hkv heads)."""
    nbytes = b * d * (2 * h * s + 2 * (hkv or h) * t) * dtype.itemsize
    return 4.0 * d * b * h * band_pairs(s, t, causal, window), nbytes


def backward_cost(b: int, h: int, s: int, t: int, d: int, causal: bool,
                  window: Optional[int], dtype: torch.dtype,
                  hkv: Optional[int] = None):
    """(flops, bytes) of the gradient dq, dk, dv from q, k, v and do: the
    scores recomputed (q·kᵀ), then do·vᵀ, pᵀ·do, ds·k and dsᵀ·q, 10·D
    flops a pair in the band; q, k, v and do read once, dq, dk and dv
    written once."""
    nbytes = b * d * (3 * h * s + 4 * (hkv or h) * t) * dtype.itemsize
    return 10.0 * d * b * h * band_pairs(s, t, causal, window), nbytes


def sharding(q, k, v, causal, window, scale):
    """K3's DTensor rule, for one mesh dim: all replicated; the batch
    split; or the heads split, q's and K/V's alike. The heads' split is
    kept only where it divides both H and Hkv (``oplib``): a rank then
    holds H/n query heads over Hkv/n KV heads, and the kernel's group
    H_local/Hkv_local is the model's. S and T are never split: each query
    needs every key of its band."""
    from torch.distributed.tensor import Replicate, Shard
    none = (None, None, None)
    return [([Replicate()], [Replicate()] * 3 + list(none)),
            ([Shard(0)], [Shard(0)] * 3 + list(none)),
            ([Shard(1)], [Shard(1)] * 3 + list(none))]


_op = oplib.define(
    "flash_attention",
    "(Tensor q, Tensor k, Tensor v, bool causal, int? window, float scale)"
    " -> Tensor",
    cuda=lambda *args: _kernel(*args),
    cpu=lambda q, k, v, causal, window, scale: flash_attention_ref(
        q, k, v, causal=causal, window=window, scale=scale),
    fake=lambda q, k, v, causal, window, scale: q.new_empty(q.shape),
    cost=lambda q, k, v, causal, window, scale: cost(
        q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3], causal,
        window, q.dtype, k.shape[1]),
    sharding=sharding)


class _FlashAttention(torch.autograd.Function):
    """Kernel forward; backward = the VJP of ``flash_attention_ref``,
    recomputed from the saved inputs. On ``DTensor``s the VJP runs on each
    rank's shards, placed as the forward's output (``sharding.dtensor.
    local_vjp``): the rule splits batch and heads only."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, scale)
        out = _op(q, k, v, causal, window, scale)
        ctx.sharded = ((out.device_mesh, out.placements)
                       if is_dtensor(out) else None)
        return out

    @staticmethod
    def backward(ctx, g):
        causal, window, scale = ctx.args

        def vjp(q, k, v, g):
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_(True) for t in (q, k, v)]
                out = flash_attention_ref(*qkv, causal=causal, window=window,
                                          scale=scale)
                return torch.autograd.grad(out, qkv, g)
        if ctx.sharded is None:
            return (*vjp(*ctx.saved_tensors, g), None, None, None)
        mesh, p = ctx.sharded
        return (*local_vjp(vjp, mesh, (*ctx.saved_tensors, g), [p] * 4,
                           [p] * 3), None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,S,D), k/v (B,Hkv,T,D) float32/bfloat16, H a multiple of Hkv
    -> (B,H,S,D), the dtype of q; differentiable (see the module
    docstring).

    A CUDA tensor goes to the kernel (contiguous, bf16 16-byte aligned, D in
    ``HEAD_DIMS``; a failed build or launch raises); a CPU tensor goes to
    ``flash_attention_ref``. Each kernel launch adds one to
    ``flash_attention.launches``.
    """
    _check(q, k, v, causal, window)
    scale = scale if scale is not None else q.shape[3] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, window, scale)


flash_attention.launches = 0
