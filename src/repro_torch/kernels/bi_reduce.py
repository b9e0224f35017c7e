"""Batch-invariant float32 reductions over the middle axis of x (R, M, D):

    SUM        (R, D)  out[r, d] = sum_m x[r, m, d]
    LOGSUMEXP  (R, 1)  log(sum_m exp(x[r, m] - max_m x[r, m])) + max, D = 1
    ARGMAX     (R, 1)  the first m of the largest x[r, m], int64, D = 1

``bi_reduce`` launches the hand-written Hopper kernel ``csrc/bi_reduce.cu``
on CUDA tensors and runs the plain PyTorch version ``bi_reduce_ref``
(``sum``, ``logsumexp``, ``argmax`` over axis 1) on CPU tensors; there is
no other path. Both routes are the operator
``torch.ops.repro_torch.bi_reduce`` (``kernels/oplib.py``).

It replaces no TPU kernel: it is the port's own, for the task plane
(``models/batch_invariant.py``), whose every float32 reduction on the
card it computes so that a row's result depends on the row alone, not on
how many rows share the call, and zeros appended to a row change no bit
(see the source for the order). ``bi_reduce_chain_ref`` and
``bi_logsumexp_chain_ref`` are the sum's and the logsumexp's order in
plain PyTorch: the oracles of the tests and of ``chip_smoke.py``, on no
path of the port.

Bound on the card: bytes, each input read once and each output written
once; at the task plane's sizes (at most a few MB a call) the launch and
a chain's latency. A sum runs a warp a row or a thread a column, 8 loads
of a chain in flight; a long row (D = 1) gets a block, whose other warps
keep the row's next elements in flight in shared memory. logsumexp and
argmax stage a tile of rows of more than 12 in shared memory by
coalesced copies, and a thread walks each row there; shorter rows are
walked in device memory.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, oplib

SUM, LOGSUMEXP, ARGMAX = 0, 1, 2
MODES = {SUM: "sum", LOGSUMEXP: "logsumexp", ARGMAX: "argmax"}


def _check(x: torch.Tensor, mode: int) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode}")
    if x.dim() != 3:
        raise ValueError(f"x must be 3-D (R, M, D), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if mode != SUM and (x.shape[2] != 1 or x.shape[1] < 1):
        raise ValueError(f"{MODES[mode]} takes x (R, M >= 1, 1), got "
                         f"{tuple(x.shape)}")


def bi_reduce_ref(x: torch.Tensor, mode: int = SUM) -> torch.Tensor:
    """Plain PyTorch version: torch's reduction of axis 1."""
    _check(x, mode)
    if mode == SUM:
        return x.sum(1)
    if mode == LOGSUMEXP:
        return torch.logsumexp(x, 1)
    return torch.argmax(x, 1)


def bi_reduce_chain_ref(x: torch.Tensor) -> torch.Tensor:
    """The kernel's sum in its own order, in plain PyTorch float32 adds
    (exact IEEE on any device): D > 1, each column's chain over m in
    order from +0; D = 1, lane j's chain over the elements j, j + 32, ...
    from +0 (the row padded with zeros to a multiple of 32, which changes
    no chain), then the lanes' tree: lane j plus lane j + h for h = 16, 8,
    4, 2, 1. Equal to ``bi_reduce(x, SUM)`` bit for bit."""
    _check(x, SUM)
    r, m, d = x.shape
    if d > 1:
        acc = x.new_zeros((r, d))
        for i in range(m):
            acc = acc + x[:, i]
        return acc
    lanes = torch.cat([x[:, :, 0], x.new_zeros((r, -m % 32))], 1)
    lanes = lanes.reshape(r, -1, 32)
    acc = x.new_zeros((r, 32))
    for i in range(lanes.shape[1]):
        acc = acc + lanes[:, i]
    h = 16
    while h:
        acc = acc[:, :h] + acc[:, h:2 * h]
        h //= 2
    return acc


def bi_logsumexp_chain_ref(x: torch.Tensor) -> torch.Tensor:
    """The kernel's logsumexp in its own order, in plain PyTorch float32
    operations: the maximum the first element that no later one is above
    (greater, or a NaN over a number: the first NaN stays), from -inf;
    then, with ``sub`` the maximum, or +0 where it is infinite (as
    ``jax.nn.logsumexp`` and ``torch.logsumexp`` take it), s += exp(x[m]
    - sub) for m in order from +0; then log(s) + sub. So a row holding
    +inf reads +inf and a row of -inf reads log(0) = -inf, as theirs do;
    a finite or NaN maximum is subtracted itself. Equal to ``bi_reduce(x,
    LOGSUMEXP)`` bit for bit where ``torch.exp`` and ``torch.log`` round
    as the kernel's ``expf`` and ``logf`` do (on the card)."""
    _check(x, LOGSUMEXP)
    v = x[:, :, 0]
    mx = v.new_full((v.shape[0],), float("-inf"))
    for i in range(v.shape[1]):
        c = v[:, i]
        mx = torch.where((c > mx) | (c.isnan() & ~mx.isnan()), c, mx)
    sub = torch.where(mx.isinf(), 0.0, mx)
    e = torch.exp(v - sub[:, None])
    s = v.new_zeros(v.shape[0])
    for i in range(v.shape[1]):
        s = s + e[:, i]
    return (torch.log(s) + sub)[:, None]


def _out_shape(x: torch.Tensor):
    return (x.shape[0], x.shape[2])


def cost(r: int, m: int, d: int, mode: int):
    """(flops, bytes): one operation an element (the sum's add; logsumexp
    counts its subtract, exp and add as three); x read once, the output
    written once (8 bytes an argmax index)."""
    per = 3.0 if mode == LOGSUMEXP else 1.0
    return per * r * m * d, 4.0 * r * m * d + (8.0 if mode == ARGMAX
                                               else 4.0) * r * d


@functools.cache
def _launchers():
    lib = build.load("bi_reduce")
    fns = {SUM: lib.bi_sum_f32, LOGSUMEXP: lib.bi_logsumexp_f32,
           ARGMAX: lib.bi_argmax_f32}
    for mode, fn in fns.items():
        sizes = 3 if mode == SUM else 2
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * sizes
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fns


def _kernel(x: torch.Tensor, mode: int) -> torch.Tensor:
    """One launch of the CUDA kernel on a contiguous x, on the current
    device's current stream, read raw (as ``bi_gemm``'s)."""
    dev = x.get_device()
    if dev != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return _kernel(x, mode)
    r, m, d = x.shape
    out = torch.empty(_out_shape(x), device=x.device,
                      dtype=torch.int64 if mode == ARGMAX else torch.float32)
    sizes = (r, m, d) if mode == SUM else (r, m)
    err = _launchers()[mode](x.data_ptr(), out.data_ptr(), *sizes,
                             torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"bi_reduce kernel launch failed: cudaError_t "
                           f"{err}")
    bi_reduce.launches += 1
    return out


_op = oplib.define(
    "bi_reduce", "(Tensor x, int mode) -> Tensor",
    cuda=lambda *args: _kernel(*args),
    cpu=bi_reduce_ref,
    fake=lambda x, mode: x.new_empty(
        _out_shape(x), dtype=torch.int64 if mode == ARGMAX else x.dtype),
    cost=lambda x, mode: cost(*x.shape, mode))


def bi_reduce(x: torch.Tensor, mode: int = SUM) -> torch.Tensor:
    """x (R, M, D) float32 -> the reduction of axis 1, (R, D): float32, or
    int64 for ``ARGMAX``; ``LOGSUMEXP`` and ``ARGMAX`` need D = 1.

    A CUDA tensor goes to the kernel (made contiguous first; a failed
    build or launch raises); a CPU tensor goes to ``bi_reduce_ref``. Each
    kernel launch adds one to ``bi_reduce.launches``.
    """
    _check(x, mode)
    return _op(x.contiguous(), mode)


bi_reduce.launches = 0
