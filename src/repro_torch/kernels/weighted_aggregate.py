"""FedAvg weighted aggregation (the paper's Alg. 1 line 13):

    g = sum_k (D_k / D_t) Omega_k

over N stacked client updates, flattened to (N, M).

``weighted_aggregate`` launches the hand-written Hopper kernel
``csrc/weighted_aggregate.cu`` on a CUDA tensor and runs the plain PyTorch
version ``weighted_aggregate_ref`` on a CPU tensor; there is no other path.
It replaces the Pallas TPU kernel ``repro/kernels/weighted_aggregate.py``
(``_agg_kernel`` / ``weighted_aggregate``). Both routes are the operator
``torch.ops.repro_torch.weighted_aggregate`` (``kernels/oplib.py``), whose
fake implementation serves ``meta`` tensors and whose cost is ``cost``.

Bound on the card: memory. The kernel must read (N*M + N) values and write
M, so its least time is (N*M + M + N) * bytes / 3.35 TB/s — about 2 us at
the main path's N = 32, M = 50,890 in f32. That is below the launch
latency, so on the main path the kernel is launch-bound; making it faster
(fusing it into the round's other work) is later work.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, oplib

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_ROWS = 48 * 1024 // 4     # weights in the kernel's 48 KB shared memory


def _check(stacked: torch.Tensor, weights: torch.Tensor) -> None:
    if stacked.dim() != 2:
        raise ValueError(f"stacked must be 2-D (N, M), got shape "
                         f"{tuple(stacked.shape)}")
    n, m = stacked.shape
    if not 1 <= n <= _MAX_ROWS or m < 1:
        raise ValueError(f"need 1 <= N <= {_MAX_ROWS} and M >= 1, got "
                         f"({n}, {m})")
    if stacked.dtype not in _DTYPES:
        raise TypeError(f"stacked dtype must be float32 or bfloat16, got "
                        f"{stacked.dtype}")
    if not stacked.is_contiguous():
        raise ValueError("stacked must be contiguous")
    if tuple(weights.shape) != (n,):
        raise ValueError(f"weights must have shape ({n},), got "
                         f"{tuple(weights.shape)}")
    if weights.device != stacked.device:
        raise ValueError(f"weights on {weights.device}, stacked on "
                         f"{stacked.device}")


def _normalized(weights: torch.Tensor,
                assume_normalized: bool) -> torch.Tensor:
    w = weights.to(torch.float32)
    if not assume_normalized:
        w = w / w.sum().clamp_min(1e-9)
    return w.contiguous()


@functools.cache
def _launchers():
    """{dtype: C launcher} of the built kernel, argument types declared."""
    lib = build.load("weighted_aggregate")
    fns = {torch.float32: lib.weighted_aggregate_f32,
           torch.bfloat16: lib.weighted_aggregate_bf16}
    for fn in fns.values():
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def weighted_aggregate_ref(stacked: torch.Tensor, weights: torch.Tensor, *,
                           assume_normalized: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the kernel's in-order f32 loop,
    acc = 0; acc += w[i] * x[i] for i = 0..N-1; cast to the input dtype."""
    _check(stacked, weights)
    w = _normalized(weights, assume_normalized)
    acc = torch.zeros(stacked.shape[1], dtype=torch.float32,
                      device=stacked.device)
    for i in range(stacked.shape[0]):
        acc = acc + w[i] * stacked[i].to(torch.float32)
    return acc.to(stacked.dtype)


def cost(n: int, m: int, dtype: torch.dtype):
    """(flops, bytes) of (N, M) x (N,) -> (M,): 2·N·M flops; each input
    read once (the float32 weights too) and the output written once."""
    return 2.0 * n * m, (n * m + m) * dtype.itemsize + n * 4


def _kernel(stacked: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One launch of the CUDA kernel over normalised float32 weights."""
    n, m = stacked.shape
    out = torch.empty(m, dtype=stacked.dtype, device=stacked.device)
    fn = _launchers()[stacked.dtype]
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(stacked.data_ptr(), w.data_ptr(), out.data_ptr(), n, m,
                 stream)
    if err != 0:
        raise RuntimeError(f"weighted_aggregate kernel launch failed: "
                           f"cudaError_t {err}")
    weighted_aggregate.launches += 1
    return out


_op = oplib.define(
    "weighted_aggregate", "(Tensor stacked, Tensor w) -> Tensor",
    cuda=lambda *args: _kernel(*args),
    cpu=lambda stacked, w: weighted_aggregate_ref(stacked, w,
                                                  assume_normalized=True),
    fake=lambda stacked, w: stacked.new_empty(stacked.shape[1:]),
    cost=lambda stacked, w: cost(*stacked.shape, stacked.dtype))


def weighted_aggregate(stacked: torch.Tensor, weights: torch.Tensor, *,
                       assume_normalized: bool = False) -> torch.Tensor:
    """stacked (N, M) float32/bfloat16, weights (N,) -> (M,) weighted mean,
    in the dtype of ``stacked``, accumulated in float32 over the rows in
    order.

    assume_normalized — weights already sum to 1 (pre-normalised in float64
    by ``federated.aggregation``); skip the renormalisation so the caller's
    rounding is kept exactly.

    A CUDA tensor goes to the kernel (a failed build or launch raises); a
    CPU tensor goes to ``weighted_aggregate_ref``. Each kernel launch adds
    one to ``weighted_aggregate.launches``.
    """
    _check(stacked, weights)
    return _op(stacked, _normalized(weights, assume_normalized))


weighted_aggregate.launches = 0
