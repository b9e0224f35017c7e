"""Flash decode: one query token per head attends to a KV cache,

    o[b,h,:] = sum_{j < length} softmax_j(D^-1/2 q[b,h,:] . k[b,j,h//G,:]) v[b,j,h//G,:]

q (B,H,D), k/v (B,T,Hkv,D) -> (B,H,D) in q's dtype; G = H/Hkv query heads
share a KV head (``jnp.repeat``'s grouping, as ``models/attention.sdpa``
groups), and Hkv == H is the TPU kernel's own signature. Logits, running
max, sum and accumulator are float32; a masked logit is -1e30.

``decode_attention`` launches the hand-written Hopper kernel
``csrc/decode_attention.cu`` on CUDA tensors and runs the plain PyTorch
version ``decode_attention_ref`` on CPU tensors; there is no other path.
It replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``_decode_kernel`` / ``decode_attention``).

The cache may be a view along its position axis: the kernel takes the
batch and position strides, so ``models/attention.attn_decode`` passes a
sliding window as the slice ``[index - window + 1, index + 1)`` without a
copy. ``length`` is a host int: the positions below it are read, the
rest never (the serving path keeps the cache index on the host, so no
call synchronises with the card).

Both routes are the operator ``torch.ops.repro_torch.decode_attention``
(``kernels/oplib.py``), whose fake implementation serves ``meta`` tensors
and whose cost is ``cost``.

The kernel is forward-only, as the TPU kernel is (it has no VJP): on the
card an input that requires grad raises ``NotImplementedError`` before
any launch. On the CPU the plain version carries autograd as usual: the
operator has no autograd formula, so a CPU call that needs a gradient
calls the plain version itself.

``length < 1`` raises ``ValueError`` (ROADMAP P5): with every logit at
-1e30 the TPU kernel returns the mean of V, which a kernel that skips the
tiles at or past ``length`` cannot; no caller passes one (a decode step's
length is index + 1 >= 1).

Bound on the card: memory. K and V are read once (2·B·length·Hkv·D
elements) against 4·G·D flops a key — at ``starcoder2-15b``'s serving
shape (B 8, H 48, Hkv 4, D 128, bf16) 12 flops a byte, far below the H100's
~295 bf16 tensor-core flops a byte. The B·Hkv (b, KV head) pairs are too
few blocks to read at that rate (32 at the serving shape), so ``splits``
cuts the cache axis, and the splits' partial softmax states are merged by
the same rule: on the tensor-core route inside one thread-block cluster,
on the CUDA-core route by a second kernel from a float32 workspace.

Two routes, chosen by ``route`` from the dtype and the alignment alone
(never by a failure): bfloat16 — every serving shape of the zoo — runs on
the tensor cores (the group's G <= 16 heads as the M rows of
``mma.sync``, K and V streamed in bf16 through a ``cp.async`` ring a
warp); float32, and a bfloat16 view not 16-byte aligned, run the
CUDA-core kernel. bfloat16 with G > 16 raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build, oplib

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)    # the kernel's instantiations
TILE = 64                        # split lengths are multiples of it
MMA_ROWS = 16                    # query heads a KV head at most in bf16
# blocks an SM the split count aims at: the CUDA-core kernel stalls on each
# tile's loads and wants two; the tensor-core kernel keeps two 16-key steps
# a warp in flight, so one block an SM reads at the memory rate (PERF.md §6)
BLOCKS_PER_SM = {"cuda_cores": 2, "tensor_cores": 1}
# the tensor-core route merges a (b, KV head)'s splits in one thread-block
# cluster, at most 8 blocks
MAX_SPLITS = {"cuda_cores": None, "tensor_cores": 8}
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           length: int) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q must be (B, H, D) and k, v (B, T, Hkv, D)")
    b, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if not isinstance(length, int):
        raise TypeError(f"length must be a host int, got {type(length)}")
    if not 1 <= length <= k.shape[1]:
        raise ValueError(f"need 1 <= length <= T = {k.shape[1]}, got "
                         f"{length}")


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: int) -> torch.Tensor:
    """Plain PyTorch version (``repro.kernels.ref.decode_attention_ref``):
    the KV heads repeated to H, float32 logits, positions >= ``length``
    masked to -1e30, softmax, the probabilities cast to ``v.dtype`` before
    the second product."""
    _check(q, k, v, length)
    g = q.shape[1] // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    logits = torch.einsum("bhd,bthd->bht", q.float(),
                          k.float()) * q.shape[2] ** -0.5
    keep = torch.arange(k.shape[1], device=q.device) < length
    logits = logits.masked_fill(~keep, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bht,bthd->bhd", p.to(v.dtype), v)


@functools.cache
def _launchers():
    """{(route, dtype): C launcher} of the built kernel, argument types
    declared."""
    lib = build.load("decode_attention")
    fns = {("cuda_cores", torch.float32): lib.decode_attention_f32,
           ("cuda_cores", torch.bfloat16): lib.decode_attention_bf16,
           ("tensor_cores", torch.bfloat16): lib.decode_attention_bf16_mma}
    for (path, _), fn in fns.items():
        # the CUDA-core launchers take a workspace pointer after o
        fn.argtypes = ([ctypes.c_void_p] * (5 if path == "cuda_cores" else 4)
                       + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fns


def route(dtype: torch.dtype, group: int, aligned: bool = True) -> str:
    """The kernel a call takes: ``"tensor_cores"`` for bfloat16 with 16-byte
    aligned q, k and v (the ``cp.async`` copies move 16 bytes), else
    ``"cuda_cores"``. bfloat16 with more than 16 query heads a KV head
    (more than one m-tile of the ``mma``; no arch of the zoo has one)
    raises ``ValueError``."""
    if dtype != torch.bfloat16:
        return "cuda_cores"
    if group > MMA_ROWS:
        raise ValueError(f"bfloat16 decode takes at most {MMA_ROWS} query "
                         f"heads a KV head, got {group}")
    return "tensor_cores" if aligned else "cuda_cores"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def splits(blocks: int, length: int, n_sms: int, per_sm: int = 2,
           most: Optional[int] = None):
    """(split_len, n_split): the valid positions cut into splits of a
    multiple of 64, as many as give every SM ``per_sm`` blocks of the
    ``blocks`` (b, KV head) pairs, every split 64 positions at least, and
    no more than ``most``."""
    want = min(_cdiv(per_sm * n_sms, blocks), _cdiv(length, TILE))
    if most is not None:
        want = min(want, most)
    split_len = _cdiv(_cdiv(length, want), TILE) * TILE
    return split_len, _cdiv(length, split_len)


def _kernel(q, k, v, length: int) -> torch.Tensor:
    """One launch of the CUDA kernel; raises on what it does not take."""
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "decode_attention on the card is forward-only (the TPU kernel "
            "has no VJP, and no path differentiates a decode step)")
    b, h, d = q.shape
    hkv = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if (k.stride() != v.stride() or k.stride(3) != 1 or k.stride(2) != d):
        raise ValueError("k and v must share strides, with (Hkv, D) dense "
                         f"in each position; got {k.stride()}, "
                         f"{v.stride()}")
    aligned = (all(t.data_ptr() % 16 == 0 for t in (q, k, v))
               and k.stride(0) % 8 == 0 and k.stride(1) % 8 == 0)
    path = route(q.dtype, h // hkv, aligned)
    out = torch.empty_like(q)
    split_len, n_split = splits(b * hkv, length, sm_count(q.device),
                                BLOCKS_PER_SM[path], MAX_SPLITS[path])
    # the CUDA-core route merges its splits through a float32 workspace and
    # a second kernel; the tensor-core route inside a thread-block cluster
    ws = (torch.empty((b * h * n_split * (d + 2),), dtype=torch.float32,
                      device=q.device)
          if path == "cuda_cores" and n_split > 1 else None)
    workspace = (() if path == "tensor_cores"
                 else (0 if ws is None else ws.data_ptr(),))
    fn = _launchers()[path, q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *workspace, b, h, hkv, d, length, split_len, n_split,
                 k.stride(0), k.stride(1), d ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError_t {err}")
    decode_attention.launches += 1
    return out


def cost(b: int, h: int, hkv: int, length: int, d: int,
         dtype: torch.dtype):
    """(flops, bytes) of flash decode: 4·D flops a (query head, key); q
    read and o written once, the ``length`` valid positions of K and V
    read once."""
    return (4.0 * d * b * h * length,
            (2 * b * h * d + 2 * b * length * hkv * d) * dtype.itemsize)


_op = oplib.define(
    "decode_attention", "(Tensor q, Tensor k, Tensor v, int length) -> Tensor",
    cuda=lambda *args: _kernel(*args), cpu=decode_attention_ref,
    fake=lambda q, k, v, length: q.new_empty(q.shape),
    cost=lambda q, k, v, length: cost(q.shape[0], q.shape[1], k.shape[2],
                                      length, q.shape[2], q.dtype))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int) -> torch.Tensor:
    """q (B,H,D), k/v (B,T,Hkv,D) float32/bfloat16, 1 <= length <= T ->
    (B,H,D), the dtype of q.

    A CUDA tensor goes to the kernel ``route`` names (q contiguous, D in
    ``HEAD_DIMS``, k and v views whose (Hkv, D) are dense; a failed build
    or launch raises); a CPU tensor goes to ``decode_attention_ref``. Each
    kernel launch adds one to ``decode_attention.launches``.
    """
    _check(q, k, v, length)
    if ((q.requires_grad or k.requires_grad or v.requires_grad)
            and torch.is_grad_enabled() and q.device.type == "cpu"):
        return decode_attention_ref(q, k, v, length)
    return _op(q, k, v, length)


decode_attention.launches = 0
