"""Coordinate-wise robust aggregation for the defense plane
(``core/defenses.py``): the trimmed mean of ranks [b, n-b), or the median as
the midpoint of ranks (n-1)//2 and n//2, over the first n of N stacked
client updates flattened to (N, M).

``robust_aggregate`` launches the hand-written Hopper kernel
``csrc/robust_aggregate.cu`` on a CUDA tensor and runs the plain PyTorch
version ``robust_aggregate_ref`` on a CPU tensor; there is no other path.
It replaces the Pallas TPU kernel ``repro/kernels/robust_aggregate.py:31``
(``_robust_kernel``), an odd-even transposition sort of all N rows of a
VMEM tile with the padding rows set to +inf. Both routes are the operator
``torch.ops.repro_torch.robust_aggregate`` (``kernels/oplib.py``), whose
fake implementation serves ``meta`` tensors and whose cost is ``cost``.

Both sum the kept ranks in ascending order, one float32 add at a time, and
divide once — the order of the reference's host oracle — so the kernel, the
plain version and ``TrimmedMean/Median.aggregate_host`` agree bit for bit.

Bound on the card: memory. The kernel reads n*M values and writes M, so its
least time is (n*M + M) * bytes / 3.35 TB/s — 2.73 us at the main path's
n = 44, M = 50,890 in f32. What keeps a kernel from it is latency (a
thread sorts a column, and one wave holds ~12 warps an SM) and the sort's
integer min/max at half the float32 rate. So each thread issues all of its
column's loads at once, maps the values to order-preserving signed 32-bit
keys (every NaN, of either sign, above +inf; pad slots the largest) and
sorts them in registers with Batcher's odd-even merge network of its size
class (``SIZE_CLASSES``, the smallest class >= n), unrolled at compile
time: no shared or local memory, an integer min and max a comparator (see
the source note).

``robust_aggregate_network`` is the kernel's algorithm in plain PyTorch —
the key map (``to_keys``/``from_keys``), the pad keys, the network
(``network``, generated by the loops of the kernel's
``odd_even_merge_network``) and the predicated reductions
(``sort_keys``, ``reduce_keys``) — for the tests to hold against the plain
version; no route of the port calls it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, oplib

_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's size classes: a column of n values sorts as the smallest
# class >= n (the launcher's ``launch_class`` list in the .cu)
SIZE_CLASSES = (*range(4, 65, 4), 80, 96, 112, 128)
MAX_ROWS = SIZE_CLASSES[-1]
_MODES = {"trimmed_mean": 0, "median": 1}
ROTATION = 0x007FFFFF   # -inf's flipped bits less INT_MIN
PAD_KEY = 0x7FFFFFFF    # slots n .. C-1 of a size class C: the largest key
ACC_START = -0.0        # the exact additive identity: -0 + x = x for every x


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
    """Plain PyTorch version: ``torch.sort`` over the n real rows (every
    NaN last, of either sign, as the kernel and numpy order it), then the
    kernel's arithmetic — the ascending sequential sum of ranks
    [trim, n-trim) divided once, or the midpoint of the middle ranks; cast
    to the input dtype."""
    _check(stacked, n, trim, mode)
    xs = stacked[:n].to(torch.float32)
    # every NaN made positive: torch.sort on the card puts a NaN with its
    # sign bit set first, where numpy, the CPU and the kernel put it last
    xs = torch.sort(torch.where(xs.isnan(), float("nan"), xs), dim=0).values
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


def size_class(n: int) -> int:
    """The kernel's size class for a column of n values: the smallest of
    ``SIZE_CLASSES`` >= n; raises beyond the largest."""
    for c in SIZE_CLASSES:
        if 1 <= n <= c:
            return c
    raise ValueError(f"need 1 <= n <= {MAX_ROWS}, got n={n}")


def network(c: int) -> list:
    """The kernel's sorting network for size class ``c``: the comparators
    (a, b), a < b, of Batcher's odd-even merge sort of the next power of two
    >= c wires, those between wires < c only, as stages of disjoint
    comparators in the order of the kernel's loops
    (``odd_even_merge_network`` in the .cu, flattened there). Every
    comparator puts its minimum on wire a, so pad keys on wires >= n stay
    where they are and the cut network sorts."""
    wires = 1
    while wires < c:
        wires <<= 1
    stages = []
    p = 1
    while p < wires:
        k = p
        while k >= 1:
            stage = []
            j = k % p
            while j + k < wires:
                i = 0
                while i < k and i + j + k < wires:
                    if ((i + j) // (2 * p) == (i + j + k) // (2 * p)
                            and i + j + k < c):
                        stage.append((i + j, i + j + k))
                    i += 1
                j += 2 * k
            if stage:
                stages.append(stage)
            k >>= 1
        p <<= 1
    return stages


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value it is congruent to mod 2**32 (as int64)."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _flip(s: torch.Tensor) -> torch.Tensor:
    """The bits below the sign flipped where the sign is set: its own
    inverse."""
    return s ^ ((s >> 31) & 0x7FFFFFFF)


def to_keys(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the kernel's keys, signed 32-bit integers (held in int64)
    in the floats' order: the bits below the sign flipped in a negative
    float, then rotated down by ``ROTATION`` (mod 2**32) so that -inf's key
    is INT_MIN. A NaN with its sign bit set, whose key would lie below
    -inf's, wraps round to the top; any other NaN's key stays above
    +inf's."""
    s = x.contiguous().view(torch.int32).to(torch.int64)
    return _wrap32(_flip(s) - ROTATION)


def from_keys(key: torch.Tensor) -> torch.Tensor:
    """The inverse of ``to_keys`` (a NaN's key gives a NaN) -> float32."""
    return _flip(_wrap32(key + ROTATION)).to(torch.int32).view(torch.float32)


def sort_keys(stacked: torch.Tensor, n: int) -> torch.Tensor:
    """The kernel's keys of the first n rows of ``stacked``, widened to f32,
    padded to the size class C with ``PAD_KEY`` and sorted by the class's
    ``network``: (C, M) int64."""
    c = size_class(n)
    keys = torch.full((c, stacked.shape[1]), PAD_KEY, dtype=torch.int64,
                      device=stacked.device)
    keys[:n] = to_keys(stacked[:n].to(torch.float32))
    for stage in network(c):
        a = torch.tensor([ab[0] for ab in stage], device=keys.device)
        b = torch.tensor([ab[1] for ab in stage], device=keys.device)
        lo = torch.minimum(keys[a], keys[b])
        keys[b] = torch.maximum(keys[a], keys[b])
        keys[a] = lo
    return keys


def reduce_keys(keys: torch.Tensor, n: int, trim: int, mode: str,
                dtype: torch.dtype) -> torch.Tensor:
    """The kernel's reduction of sorted keys (C, M): the trimmed mean's
    ascending sum of ranks [trim, n - trim) from ``ACC_START``, one f32 add
    a rank, divided once, or the median's midpoint of ranks (n-1)//2 and
    n//2; cast to ``dtype``."""
    xs = from_keys(keys)
    if mode == "median":
        out = (xs[(n - 1) // 2] + xs[n // 2]) * 0.5
    else:
        out = torch.full(keys.shape[1:], ACC_START, dtype=torch.float32,
                         device=keys.device)
        for r in range(trim, n - trim):
            out = out + xs[r]
        out = out / torch.full_like(out, float(n - 2 * trim))
    return out.to(dtype)


def robust_aggregate_network(stacked: torch.Tensor, n: int, *,
                             trim: int = 0,
                             mode: str = "trimmed_mean") -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch, step for step:
    ``sort_keys`` then ``reduce_keys``. For the tests: no route of the
    port calls it."""
    _check(stacked, n, trim, mode)
    return reduce_keys(sort_keys(stacked, n), n, trim, mode, stacked.dtype)


def cost(n: int, m: int, trim: int, mode: str, dtype: torch.dtype):
    """(operations, bytes) of the robust reduce of the first n rows of (N,
    M) -> (M,): the n real rows read once and the output written once; the
    comparisons and adds, 32-bit operations (not FLOPs) — log2(n!)
    comparisons a column to order it and n - 2b adds for the trimmed mean,
    n - 1 comparisons (the least any selection needs) and 2 operations for
    the median."""
    nbytes = (n * m + m) * dtype.itemsize
    if mode == "median":
        return m * (n - 1 + 2), nbytes
    return m * (math.lgamma(n + 1) / math.log(2) + (n - 2 * trim)), nbytes


def _kernel(stacked: torch.Tensor, n: int, trim: int,
            mode: str) -> torch.Tensor:
    """One launch of the CUDA kernel."""
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


_op = oplib.define(
    "robust_aggregate", "(Tensor stacked, int n, int trim, str mode) -> Tensor",
    cuda=lambda *args: _kernel(*args),
    cpu=lambda stacked, n, trim, mode: robust_aggregate_ref(
        stacked, n, trim=trim, mode=mode),
    fake=lambda stacked, n, trim, mode: stacked.new_empty(stacked.shape[1:]),
    cost=lambda stacked, n, trim, mode: cost(n, stacked.shape[1], trim, mode,
                                             stacked.dtype))


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
    return _op(stacked, int(n), int(trim), mode)


robust_aggregate.launches = 0
