"""Batch-invariant float32 batched matrix product:

    c[z] = a[z] @ b[z]        a (Ba, M, K), b (Bb, K, N) -> c (batch, M, N)

with Ba and Bb each 1 (one matrix shared by every product) or the batch,
any strides (a transposed operand is a strided view, ``x.mT``).

``bi_gemm`` launches the hand-written Hopper kernel ``csrc/bi_gemm.cu`` on
CUDA tensors and runs the plain PyTorch version ``bi_gemm_ref``
(``torch.matmul``) on CPU tensors; there is no other path. Both routes are
the operator ``torch.ops.repro_torch.bi_gemm`` (``kernels/oplib.py``).
``bi_gemm_chain_ref`` is the kernel's order in plain PyTorch, bit for bit
on any device: the oracle of the tests and of ``chip_smoke.py``, on no
path of the port.

It replaces no TPU kernel: it is the port's own, for the task plane
(``models/batch_invariant.py``), whose every float32 product on the card
it computes so that a client's result does not depend on how many clients
share the call. Each element of c is one chain of fused multiply-adds
over k in order, in one thread, whatever the batch count, M, N or launch
(see the source). It is differentiable through
``models/batch_invariant.py``'s autograd Function, whose backward launches
this kernel again.

Bound on the card: operations at the §V evaluation (48 models x 10,000 x
784 x 64: 0.72 ms at 67 TFLOP/s), bytes at the training shapes. The
kernel's tile is chosen by shape (64 x 64 at the evaluation down to
32 x 64 at a client's 50 rows and 32 x 32 where N is at most 32), which
changes who computes an element, never how.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, oplib

_MAX_DIM = 2**31 - 1


def _batch(a: torch.Tensor, b: torch.Tensor) -> int:
    return max(a.shape[0], b.shape[0])


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"a and b must be 3-D (batch, rows, cols), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[2] != b.shape[1]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)}: "
                         "inner sizes differ")
    batch = _batch(a, b)
    if a.shape[0] not in (1, batch) or b.shape[0] not in (1, batch):
        raise ValueError(f"batch sizes {a.shape[0]} and {b.shape[0]} do "
                         "not broadcast")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"a and b must be float32, got {a.dtype} and "
                        f"{b.dtype}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if max(batch, a.shape[1], b.shape[2], a.shape[2]) > _MAX_DIM:
        raise ValueError("a dimension exceeds 2^31 - 1")


def bi_gemm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``torch.matmul`` (a batch of 1 broadcasts)."""
    _check(a, b)
    return torch.matmul(a, b)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, c)`` elementwise on float32 tensors: a·b + c rounded to
    float32 once. torch has no fused float32 multiply-add, so it is
    emulated in float64: the product of two float32 values is exact there,
    the sum is taken with its exact error (TwoSum) and rounded to odd (its
    last bit set, toward the error, where the sum was inexact and even),
    and a value rounded to odd with 53 bits rounds to float32's 24 bits as
    the exact value would (Boldo & Melquiond)."""
    # repro: allow(dtype-f64) the exact product and sum, rounded to float32
    p = a.double() * b.double()
    q = c.double()  # repro: allow(dtype-f64) as above
    s = p + q
    bv = s - p
    err = (p - (s - bv)) + (q - bv)
    odd = (err != 0) & (s.view(torch.int64) & 1 == 0) & torch.isfinite(s)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    return torch.where(odd, torch.nextafter(s, toward), s).float()


def bi_gemm_chain_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's order in plain PyTorch: each element one chain
    ``acc = fmaf(a[m, k], b[k, n], acc)`` from +0 over k = 0, ..., K - 1,
    then over zeros to the next multiple of 16 (``acc + 0``, which turns
    only a -0 into +0). Equal to ``bi_gemm`` bit for bit on every input, on
    any device; K steps of a few float64 passes, so for tests."""
    _check(a, b)
    batch, m, k, n = _batch(a, b), a.shape[1], a.shape[2], b.shape[2]
    acc = a.new_zeros((batch, m, n))
    for j in range(k):
        acc = fma32(a[:, :, j:j + 1], b[:, j:j + 1, :], acc)
    if k % 16:
        acc = acc + torch.zeros_like(acc)
    return acc


def cost(batch: int, ba: int, bb: int, m: int, n: int, k: int):
    """(flops, bytes): 2·batch·M·N·K; a and b read once (a shared operand
    once), c written once, float32."""
    return (2.0 * batch * m * n * k,
            4.0 * (ba * m * k + bb * k * n + batch * m * n))


@functools.cache
def _launcher():
    fn = build.load("bi_gemm").bi_gemm_f32
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One launch of the CUDA kernel; a shared operand gets batch stride
    0. On the current device's current stream, read raw: cheaper on the
    host than a device guard and a ``Stream`` object."""
    dev = a.get_device()
    if dev != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return _kernel(a, b)
    batch, m, k, n = _batch(a, b), a.shape[1], a.shape[2], b.shape[2]
    out = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    sa, sb = list(a.stride()), list(b.stride())
    if a.shape[0] == 1:
        sa[0] = 0
    if b.shape[0] == 1:
        sb[0] = 0
    err = _launcher()(a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, m,
                      n, k, *sa, *sb, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"bi_gemm kernel launch failed: cudaError_t "
                           f"{err}")
    bi_gemm.launches += 1
    return out


_op = oplib.define(
    "bi_gemm", "(Tensor a, Tensor b) -> Tensor",
    cuda=lambda *args: _kernel(*args),
    cpu=bi_gemm_ref,
    fake=lambda a, b: a.new_empty((_batch(a, b), a.shape[1], b.shape[2])),
    cost=lambda a, b: cost(_batch(a, b), a.shape[0], b.shape[0], a.shape[1],
                           b.shape[2], a.shape[2]))


def bi_gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (Ba, M, K) @ b (Bb, K, N) float32 -> (batch, M, N) contiguous,
    Ba and Bb each 1 or the batch; any strides.

    A CUDA tensor goes to the kernel (a failed build or launch raises); a
    CPU tensor goes to ``bi_gemm_ref``. Each kernel launch adds one to
    ``bi_gemm.launches``.
    """
    _check(a, b)
    return _op(a, b)


bi_gemm.launches = 0
