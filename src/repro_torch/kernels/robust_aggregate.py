"""Coordinate-wise robust aggregation for the defense plane
(``core/defenses.py``): the trimmed mean of ranks [b, n-b), or the median as
the midpoint of ranks (n-1)//2 and n//2, over the first n of N stacked
client updates flattened to (N, M).

``robust_aggregate`` launches the hand-written Hopper kernel
``csrc/robust_aggregate.cu`` on a CUDA tensor and runs the plain PyTorch
version ``robust_aggregate_ref`` on a CPU tensor; there is no other path.
It replaces the Pallas TPU kernel ``repro/kernels/robust_aggregate.py:31``
(``_robust_kernel``).

Both sum the kept ranks in ascending order, one float32 add at a time, and
divide once — the order of the reference's host oracle — so the kernel, the
plain version and ``TrimmedMean/Median.aggregate_host`` agree bit for bit.

Bound on the card: memory. The kernel reads n*M values and writes M, so its
least time is (n*M + M) * bytes / 3.35 TB/s — 2.73 us at the main path's
n = 44, M = 50,890 in f32; the sort's log2(n!) comparisons a column take
~0.3 us at the card's 32-bit instruction rate. The kernel sorts each column
in shared memory by insertion sort, a simple first version (see the source
note).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
MAX_ROWS = 128      # rows a column sorts in the kernel's shared memory
_MODES = {"trimmed_mean": 0, "median": 1}


def _check(stacked: torch.Tensor, n: int, trim: int, mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if stacked.dim() != 2:
        raise ValueError(f"stacked must be 2-D (N, M), got shape "
                         f"{tuple(stacked.shape)}")
    rows, m = stacked.shape
    if not 1 <= rows <= MAX_ROWS or m < 1:
        raise ValueError(f"need 1 <= N <= {MAX_ROWS} and M >= 1, got "
                         f"({rows}, {m})")
    if stacked.dtype not in _DTYPES:
        raise TypeError(f"stacked dtype must be float32 or bfloat16, got "
                        f"{stacked.dtype}")
    if not stacked.is_contiguous():
        raise ValueError("stacked must be contiguous")
    if not (0 < n <= rows and 0 <= 2 * trim < n):
        raise ValueError(f"need 0 < n <= N and 0 <= 2*trim < n, got n={n}, "
                         f"N={rows}, trim={trim}")


@functools.cache
def _launchers():
    """{dtype: C launcher} of the built kernel, argument types declared."""
    lib = build.load("robust_aggregate")
    fns = {torch.float32: lib.robust_aggregate_f32,
           torch.bfloat16: lib.robust_aggregate_bf16}
    for fn in fns.values():
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def robust_aggregate_ref(stacked: torch.Tensor, n: int, *, trim: int = 0,
                         mode: str = "trimmed_mean") -> torch.Tensor:
    """Plain PyTorch version: ``torch.sort`` over the n real rows (NaN last,
    as the kernel and numpy order it), then the kernel's arithmetic — the
    ascending sequential sum of ranks [trim, n-trim) divided once, or the
    midpoint of the middle ranks; cast to the input dtype."""
    _check(stacked, n, trim, mode)
    xs = torch.sort(stacked[:n].to(torch.float32), dim=0).values
    if mode == "median":
        out = (xs[(n - 1) // 2] + xs[n // 2]) * 0.5
    else:
        acc = xs[trim]
        for i in range(trim + 1, n - trim):
            acc = acc + xs[i]
        # a tensor divisor: CUDA divides by a host scalar as a product
        # with its reciprocal, which is not the IEEE quotient
        out = acc / torch.full_like(acc, float(n - 2 * trim))
    return out.to(stacked.dtype)


def robust_aggregate(stacked: torch.Tensor, n: int, *, trim: int = 0,
                     mode: str = "trimmed_mean") -> torch.Tensor:
    """stacked (N, M) float32/bfloat16, first ``n`` rows real -> (M,) in the
    dtype of ``stacked``: per column, the trimmed mean of the sorted ranks
    [trim, n - trim) (``mode="trimmed_mean"``) or the median (``"median"``,
    ``trim`` unused). N <= 128.

    A CUDA tensor goes to the kernel (a failed build or launch raises); a
    CPU tensor goes to ``robust_aggregate_ref``. Each kernel launch adds one
    to ``robust_aggregate.launches``.
    """
    _check(stacked, n, trim, mode)
    if stacked.device.type == "cpu":
        return robust_aggregate_ref(stacked, n, trim=trim, mode=mode)
    if stacked.device.type != "cuda":
        raise ValueError(f"no kernel for device {stacked.device}")
    m = stacked.shape[1]
    out = torch.empty(m, dtype=stacked.dtype, device=stacked.device)
    fn = _launchers()[stacked.dtype]
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(stacked.data_ptr(), out.data_ptr(), n, m, trim,
                 _MODES[mode], stream)
    if err != 0:
        raise RuntimeError(f"robust_aggregate kernel launch failed: "
                           f"cudaError_t {err}")
    robust_aggregate.launches += 1
    return out


robust_aggregate.launches = 0
