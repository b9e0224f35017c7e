"""Grouped expert GEMM of the MoE dispatch: one product per expert,

    out[e] = x[e] @ w[e]        x (E,C,K), w (E,K,N) -> (E,C,N)

in x's dtype, each element summed in float32 and rounded once.
``models/moe.py`` sends the three expert products of every MoE layer
through it (gate and up, then down), with the capacity-padded dispatch
buffer as x.

``moe_gemm`` launches the hand-written Hopper kernel ``csrc/moe_gemm.cu``
on CUDA tensors and runs the plain PyTorch version ``moe_gemm_ref`` on CPU
tensors; there is no other path. It replaces the Pallas TPU kernel
``repro/kernels/moe_gemm.py`` (``_gemm_kernel`` / ``moe_gemm``). The TPU
kernel's ``block_c``, ``block_f`` and ``block_k`` are its tiling, not its
function, and the port takes none of them; nor does it keep the TPU
kernel's requirement that the blocks divide C, K and N (ROADMAP Queue 3):
the CUDA kernel masks every ragged edge, so the MoE capacity of any token
count is taken as it is.

The kernel is forward-only, as the TPU kernel is (it has no VJP): on the
card an input that requires grad raises, naming the slice that brings
training. On the CPU the plain version carries autograd as usual.

Bound on the card: operations at the MoE prefill (2·C flops a weight
element, C in the thousands), bytes at decode (every expert's weights read
once a launch). bfloat16 runs on the tensor cores (``mma.sync``, float32
accumulator: a bf16 product is exact in float32, so this is the TPU
kernel's cast-to-f32 dot), float32 on the CUDA cores (never TF32, which
would round the inputs).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
_TRAINING = "training the zoo, a later slice of the port"


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError("x must be (E, C, K) and w (E, K, N)")
    if w.shape[0] != x.shape[0] or w.shape[1] != x.shape[2]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not "
                         "match: need (E, C, K) and (E, K, N)")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must share one dtype, float32 or "
                        f"bfloat16; got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")


def moe_gemm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``repro.kernels.ref.moe_gemm_ref``): the
    per-expert product in float32, cast to x's dtype."""
    _check(x, w)
    return torch.einsum("eck,ekn->ecn", x.float(), w.float()).to(x.dtype)


@functools.cache
def _launchers():
    """{dtype: C launcher} of the built kernel, argument types declared."""
    lib = build.load("moe_gemm")
    fns = {torch.float32: lib.moe_gemm_f32, torch.bfloat16: lib.moe_gemm_bf16}
    for fn in fns.values():
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def _kernel(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One launch of the CUDA kernel; raises on what it does not take."""
    if x.requires_grad or w.requires_grad:
        raise NotImplementedError(
            "moe_gemm on the card is forward-only (the TPU kernel has no "
            f"VJP); its gradient comes with {_TRAINING}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    e, c, k = x.shape
    n = w.shape[2]
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _launchers()[x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, k, n,
                 stream)
    if err != 0:
        raise RuntimeError(f"moe_gemm kernel launch failed: cudaError_t "
                           f"{err}")
    moe_gemm.launches += 1
    return out


def moe_gemm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E,C,K), w (E,K,N), one dtype (float32 or bfloat16) -> (E,C,N).

    A CUDA tensor goes to the kernel (contiguous x and w, no input that
    requires grad; a failed build or launch raises); a CPU tensor goes to
    ``moe_gemm_ref``. Each kernel launch adds one to
    ``moe_gemm.launches``.
    """
    _check(x, w)
    if x.device.type == "cpu":
        return moe_gemm_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _kernel(x, w)


moe_gemm.launches = 0
