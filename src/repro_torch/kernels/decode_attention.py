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

The kernel is forward-only, as the TPU kernel is (it has no VJP): on the
card an input that requires grad raises ``NotImplementedError`` before
any launch. On the CPU the plain version carries autograd as usual.

``length < 1`` raises ``ValueError`` (ROADMAP P5): with every logit at
-1e30 the TPU kernel returns the mean of V, which a kernel that skips the
tiles at or past ``length`` cannot; no caller passes one (a decode step's
length is index + 1 >= 1).

Bound on the card: memory. K and V are read once (2·B·length·Hkv·D
elements) against 4·G·D flops a key — at ``starcoder2-15b``'s serving
shape (B 8, H 48, Hkv 4, D 128, bf16) 12 flops a byte, far below the H100's
~295 bf16 tensor-core flops a byte. The B·Hkv (b, KV head) pairs are too
few blocks to read at that rate (32 at the serving shape), so ``splits``
cuts the cache axis until every SM has two, and a second kernel merges
the splits' partial softmax states from a float32 workspace.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)    # the kernel's instantiations
TILE = 64                        # cache positions the kernel stages at once
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
    """{dtype: C launcher} of the built kernel, argument types declared."""
    lib = build.load("decode_attention")
    fns = {torch.float32: lib.decode_attention_f32,
           torch.bfloat16: lib.decode_attention_bf16}
    for fn in fns.values():
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fns


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def splits(blocks: int, length: int, n_sms: int):
    """(split_len, n_split): the valid positions cut into splits of a
    multiple of 64 (the kernel's tile), as many as give every SM two
    blocks of the ``blocks`` (b, KV head) pairs and every split one tile
    at least."""
    want = min(_cdiv(2 * n_sms, blocks), _cdiv(length, TILE))
    split_len = _cdiv(_cdiv(length, want), TILE) * TILE
    return split_len, _cdiv(length, split_len)


def _kernel(q, k, v, length: int) -> torch.Tensor:
    """One launch of the CUDA kernel; raises on what it does not take."""
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "decode_attention on the card is forward-only (the TPU kernel "
            "has no VJP); its backward kernel comes with training the zoo "
            "(ROADMAP Queue 1 item 9)")
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
    out = torch.empty_like(q)
    n_sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    split_len, n_split = splits(b * hkv, length, n_sms)
    ws = (torch.empty((b * h * n_split * (d + 2),), dtype=torch.float32,
                      device=q.device) if n_split > 1 else None)
    fn = _launchers()[q.dtype]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 0 if ws is None else ws.data_ptr(), b, h, hkv, d, length,
                 split_len, n_split, k.stride(0), k.stride(1), d ** -0.5,
                 stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError_t {err}")
    decode_attention.launches += 1
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: int) -> torch.Tensor:
    """q (B,H,D), k/v (B,T,Hkv,D) float32/bfloat16, 1 <= length <= T ->
    (B,H,D), the dtype of q.

    A CUDA tensor goes to the kernel (q contiguous, D in ``HEAD_DIMS``, k
    and v views whose (Hkv, D) are dense; a failed build or launch
    raises); a CPU tensor goes to ``decode_attention_ref``. Each kernel
    launch adds one to ``decode_attention.launches``.
    """
    _check(q, k, v, length)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, length)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _kernel(q, k, v, length)


decode_attention.launches = 0
