"""Mamba2 SSD scan (state-space duality, [arXiv:2405.21060]): the
recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t (x) x_t,    y_t = C_t . h_t

over x (B,L,H,P), dt (B,L,H) float32, A (H,) float32 and grouped B/C
(B,L,G,N) (head h reads group h // (H/G); G == H is the TPU kernel's own
signature), computed chunk by chunk: per chunk of Q positions the
intra-chunk term (C Bᵀ ∘ tril(exp(cum_i − cum_j))) (x dt), the inter-chunk
term C exp(cum) · state, and the state update. Returns y (B,L,H,P) in x's
dtype and the final state (B,H,N,P) float32; every sum and exponent is
float32, and every product is float32 or, on the tensor-core route, a
bf16 product summed in float32 whose float32 operands enter as hi/lo
pairs. ``initial_state`` (B,H,N,P) starts the recurrence (zero when None,
as the TPU kernel's ``_init``).

``ssd_scan`` launches the hand-written Hopper kernel ``csrc/ssd_scan.cu``
on CUDA tensors and runs the plain PyTorch version ``ssd_scan_ref`` (the
sequential recurrence of ``repro.kernels.ref.ssd_ref``) on CPU tensors;
there is no other path. It replaces the Pallas TPU kernel
``repro/kernels/ssd_scan.py`` (``_ssd_kernel`` / ``ssd_scan``), which
keeps the state in VMEM scratch across a sequential chunk axis; the TPU
kernel returns y only, while this one also writes the final state, which
``models/ssm.ssm_apply`` hands to the decode cache.

``ssd_scan`` is differentiable on both devices through one
``torch.autograd.Function`` (the TPU kernel has no VJP; the reference's
models train with the chunked jnp form, ``models/ssm.py::ssd_chunked``).
Its forward is the dispatch above (the kernel on the card). Its backward
recomputes ``ssd_chunked`` — the reference's training formula, kept here —
from the saved inputs and returns its VJP for x, dt, A, B, C and the
initial state: the pattern of K3's ``_FlashAttention`` and of the
reference's ``ops.flash_attention`` custom VJP, a plain backward on the
card by declaration. Not the sequential ``ssd_scan_ref``, whose VJP would
be L dependent steps. A launch of ``_kernel`` alone carries no gradient,
so it raises ``NotImplementedError`` for an input that requires grad while
grad mode is on; the Function calls it with grad mode off.

``compute_dtype`` (the reference's ``ssm.compute_dtype``) is float32 or
bfloat16. In bfloat16 the intra-chunk operands — the decay matrix, the
scores C·Bᵀ and x·dt — are rounded to bf16, their products summed in
float32, and the inter-chunk state stays float32 (the reference's
``ssd_chunked(compute_dtype=)``): on a CPU tensor the plain
``ssd_chunked`` at that precision, on a CUDA tensor the tensor-core route
with every operand entering ``mma.sync`` as one bf16 (no hi/lo pair). That
route takes bfloat16 inputs of the tensor-core shapes only; any other call
with bf16 compute raises, so it never runs in float32 unasked.

Both devices and ``meta`` go through the operator
``torch.ops.repro_torch.ssd_scan`` (``kernels/oplib.py``), whose fake
implementation makes the outputs' shapes and whose cost is ``cost``.

Q = min(chunk, L) must divide L; otherwise ``ValueError`` (the JAX
package asserts it, ROADMAP P3). x, B and C may be views whose last two
axes are dense (``ssm_apply`` passes slices of the convolved projection
without a copy).

Three routes, chosen by ``route`` from the dtype, the compute dtype, the
shapes and the alignment alone (never by a failure). bfloat16 with P in {16, 32, 64, 128},
N a multiple of 16 up to 128 and Q a multiple of 64 — ``mamba2-370m`` and
Jamba — runs chunk-parallel on the tensor cores, Mamba2's own
decomposition in three kernels: the chunks' local states, the state
passing across chunks, and the chunk scan (every float32 operand of a
product split into a bf16 hi/lo pair, so no operand is rounded once;
the workspaces, 8·N·P + 8·Q bytes a (b, h, chunk), allocated here).
At bf16 compute the same three kernels take every operand as one bf16
(``"tensor_cores_bf16"``, the template flag ``kSplit`` off). float32, and
any other bfloat16 shape, runs the CUDA-core kernel: a block a (b, h, P
tile) walking the chunks in order.

Bound on the card: per (b, h, chunk) Q·N·Q flops for the causal scores,
Q·P·Q for their product with x·dt and 4·Q·N·P for the inter-chunk term and
the state update. At the serving shape (``mamba2-370m``: Q 256, N 128, P
64, bf16) that is ~290 flops a byte moved, level with the H100's bf16
tensor-core balance point: bytes and operations bound it alike.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build, oplib

P_TILES = (64, 32, 16)      # the kernel's instantiations (columns of P)
MAX_STATE = 128             # N the kernel's register tile holds
MAX_CHUNK = 1024
MMA_HEAD_DIMS = (16, 32, 64, 128)   # P of the tensor-core route
MMA_TILE = 64               # its tile of positions: Q a multiple of it
_DTYPES = (torch.float32, torch.bfloat16)
_COMPUTE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(value) -> torch.dtype:
    """``ssm.compute_dtype`` ("float32" / "bfloat16", or the torch dtype)
    as a torch dtype; anything else raises ``ValueError``."""
    dt = _COMPUTE.get(value, value)
    if dt not in _COMPUTE.values():
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{value!r}")
    return dt


def _check(x, dt, A, B_, C_, chunk: int, initial_state) -> int:
    """Validate the inputs; returns the chunk length Q = min(chunk, L)."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1:
        raise ValueError("x must be (B, L, H, P), dt (B, L, H), A (H,)")
    b, length, h, p = x.shape
    if B_.dim() != 4 or B_.shape != C_.shape or B_.shape[:2] != (b, length):
        raise ValueError(f"B {tuple(B_.shape)} and C {tuple(C_.shape)} must "
                         f"be (B, L, G, N) beside x {tuple(x.shape)}")
    if h % B_.shape[2]:
        raise ValueError(f"{h} heads are not a multiple of {B_.shape[2]} "
                         "B/C groups")
    if dt.shape != (b, length, h) or A.shape != (h,):
        raise ValueError(f"dt {tuple(dt.shape)} / A {tuple(A.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if x.dtype not in _DTYPES or B_.dtype != x.dtype or C_.dtype != x.dtype:
        raise TypeError(f"x, B, C must share one dtype, float32 or bfloat16; "
                        f"got {x.dtype}, {B_.dtype}, {C_.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError("dt and A must be float32")
    if initial_state is not None and (
            initial_state.shape != (b, h, B_.shape[3], p)
            or initial_state.dtype != torch.float32):
        raise ValueError(f"initial_state must be float32 (B, H, N, P) = "
                         f"{(b, h, B_.shape[3], p)}")
    devices = {t.device for t in (x, dt, A, B_, C_)}
    if initial_state is not None:
        devices.add(initial_state.device)
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    q = min(chunk, length)
    if q < 1 or length % q:
        raise ValueError(f"sequence length {length} is not a multiple of "
                         f"the chunk {q}")
    return q


def ssd_scan_ref(x, dt, A, B_, C_, *, chunk: int = 128,
                 initial_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the sequential recurrence of
    ``repro.kernels.ref.ssd_ref`` (grouped B/C repeated to H heads), one
    position at a time in float32. ``chunk`` is only validated (L must be
    a multiple of it), so both routes accept the same calls."""
    _check(x, dt, A, B_, C_, chunk, initial_state)
    b, length, h, p = x.shape
    rep = h // B_.shape[2]
    bh = B_.repeat_interleave(rep, dim=2).float()
    ch = C_.repeat_interleave(rep, dim=2).float()
    state = (torch.zeros(b, h, B_.shape[3], p, dtype=torch.float32,
                         device=x.device)
             if initial_state is None else initial_state.clone())
    ys = []
    for t in range(length):
        dtt = dt[:, t]
        decay = torch.exp(dtt * A)                                # (B,H)
        upd = torch.einsum("bhn,bhp->bhnp", bh[:, t],
                           (x[:, t] * dtt[..., None]).float())
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhn,bhnp->bhp", ch[:, t], state))
    return torch.stack(ys, 1).to(x.dtype), state


def ssd_chunked(x, dt, A, Bh, Ch, chunk: int, initial_state=None,
                compute_dtype=torch.float32):
    """The JAX package's chunked SSD in plain PyTorch. x (B,L,H,P); dt
    (B,L,H) float32; A (H,); Bh/Ch (B,L,H,N) (per head). Returns (y
    (B,L,H,P) in x's dtype, final state (B,H,N,P) float32). L must be a
    multiple of min(chunk, L) (``ValueError`` otherwise; the JAX package
    asserts it). ``compute_dtype`` bfloat16 rounds the decay matrix, the
    scores C·Bᵀ (summed in float32, rounded once), their product and x·dt
    to bf16, as the reference's ``preferred_element_type`` products do;
    every sum stays float32, and so does the inter-chunk state (from the
    rounded x·dt)."""
    b, length, h, p = x.shape
    n = Bh.shape[-1]
    q = min(chunk, length)
    if length % q:
        raise ValueError(f"sequence length {length} is not a multiple of "
                         f"the chunk {q}")
    nc = length // q
    r = lambda t: t.reshape(b, nc, q, *t.shape[2:])
    xc, dtc, bc, cc = r(x), r(dt), r(Bh), r(Ch)

    cum = torch.cumsum(dtc * A, dim=2)                           # (B,nc,Q,H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B,nc,Q,Q,H)
    iq = torch.arange(q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    # masked before the exponent: above the diagonal seg is positive and
    # exp(seg) overflows once a chunk's decay passes e^88, and the VJP of
    # where(causal, exp(seg), 0) is then 0·inf = NaN (ROADMAP R7). The
    # forward is the same bits: exp(-inf) = 0
    cdt = compute_dtype_of(compute_dtype)
    lmat = torch.exp(seg.masked_fill(~causal, float("-inf"))).to(cdt)
    xdt = (xc * dtc[..., None]).to(cdt)
    g = torch.einsum("bcqhn,bckhn->bcqkh", cc.float(), bc.float()).to(cdt)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", (g * lmat).float(),
                           xdt.float())

    decay_end = torch.exp(cum[:, :, -1:, :] - cum)               # (B,nc,Q,H)
    s_local = torch.einsum("bckhn,bckhp->bchnp",
                           (bc * decay_end[..., None]).float(), xdt.float())
    chunk_decay = torch.exp(cum[:, :, -1, :])                    # (B,nc,H)
    state = (torch.zeros(b, h, n, p, dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + s_local[:, c]
    s_prev = torch.stack(prev, 1)                                # (B,nc,H,N,P)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           (cc * torch.exp(cum)[..., None]).float(), s_prev)
    y = (y_intra + y_inter).reshape(b, length, h, p)
    return y.to(x.dtype), state


@functools.cache
def _launchers():
    """{(route, dtype): C launcher} of the built kernel, argument types
    declared."""
    lib = build.load("ssd_scan")
    fns = {("cuda_cores", torch.float32): lib.ssd_scan_f32,
           ("cuda_cores", torch.bfloat16): lib.ssd_scan_bf16}
    for fn in fns.values():
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    fn = lib.ssd_scan_bf16_chunked
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fns["tensor_cores", torch.bfloat16] = fn
    fns["tensor_cores_bf16", torch.bfloat16] = fn
    return fns


def route(dtype: torch.dtype, p: int, n: int, q: int,
          aligned: bool = True, compute_dtype=torch.float32) -> str:
    """The kernel a call takes: ``"tensor_cores"`` for bfloat16 with P in
    ``MMA_HEAD_DIMS``, N a multiple of 16 up to 128, the chunk Q a multiple
    of 64 and 16-byte aligned inputs (the ``cp.async`` copies move 16
    bytes), else ``"cuda_cores"``. With bf16 compute, ``"tensor_cores_bf16"``
    (the same kernels, every operand one bf16) on the same condition, and
    ``ValueError`` where it does not hold: no other kernel computes in
    bf16."""
    mma = (dtype == torch.bfloat16 and p in MMA_HEAD_DIMS and n % 16 == 0
           and 16 <= n <= MAX_STATE and q % MMA_TILE == 0 and aligned)
    if compute_dtype_of(compute_dtype) == torch.bfloat16:
        if not mma:
            raise ValueError(
                f"bf16 compute runs on the tensor-core route only: bfloat16 "
                f"inputs (got {dtype}), P in {MMA_HEAD_DIMS} (got {p}), N a "
                f"multiple of 16 up to {MAX_STATE} (got {n}), the chunk a "
                f"multiple of {MMA_TILE} (got {q}), 16-byte aligned "
                f"(got {aligned})")
        return "tensor_cores_bf16"
    return "tensor_cores" if mma else "cuda_cores"


def _p_tile(b: int, h: int, p: int, n_sms: int) -> int:
    """Columns of P a block takes: the widest tile that still gives every
    SM a block, else the narrowest that divides P (splitting P is exact;
    each P tile recomputes C Bᵀ)."""
    tiles = [t for t in P_TILES if p % t == 0]
    if not tiles:
        raise ValueError(f"head dim P = {p} is not a multiple of 16")
    for t in tiles:
        if b * h * (p // t) >= n_sms:
            return t
    return tiles[-1]


def _kernel(x, dt, A, B_, C_, q: int, initial_state,
            compute_dtype=torch.float32):
    """One launch of the CUDA kernel; raises on what it does not take."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B_, C_, initial_state)):
        raise NotImplementedError(
            "a launch of the ssd_scan kernel is forward-only: differentiate "
            "through ssd_scan, whose autograd Function recomputes the "
            "chunked form for the backward")
    b, length, h, p = x.shape
    g, n = B_.shape[2], B_.shape[3]
    if n > MAX_STATE:
        raise ValueError(f"state size N = {n} > {MAX_STATE}")
    if q > MAX_CHUNK:
        raise ValueError(f"chunk {q} > {MAX_CHUNK}")
    for name, t, inner in (("x", x, p), ("B", B_, n), ("C", C_, n)):
        if t.stride(3) != 1 or t.stride(2) != inner:
            raise ValueError(f"{name}'s last two axes must be dense; "
                             f"strides {t.stride()}")
    dt, A = dt.contiguous(), A.contiguous()
    if initial_state is not None:
        initial_state = initial_state.contiguous()
    strides = (x.stride(0), x.stride(1), B_.stride(0), B_.stride(1),
               C_.stride(0), C_.stride(1))
    aligned = (all(t.data_ptr() % 16 == 0 for t in (x, B_, C_))
               and all(st % 8 == 0 for st in strides)
               and (initial_state is None
                    or initial_state.data_ptr() % 16 == 0))
    path = route(x.dtype, p, n, q, aligned, compute_dtype)
    y = torch.empty((b, length, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    init = 0 if initial_state is None else initial_state.data_ptr()
    fn = _launchers()[path, x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if path.startswith("tensor_cores"):
            units = b * h * (length // q)
            states = torch.empty((units * n * p,), dtype=torch.float32,
                                 device=x.device)
            fac = torch.empty((units * 2 * q,), dtype=torch.float32,
                              device=x.device)
            prev = torch.empty((units * 2 * n * p,), dtype=torch.bfloat16,
                               device=x.device)
            err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     B_.data_ptr(), C_.data_ptr(), init, y.data_ptr(),
                     state.data_ptr(), states.data_ptr(), fac.data_ptr(),
                     prev.data_ptr(), b, length, h, g, p, n, q,
                     int(path == "tensor_cores_bf16"), *strides, stream)
        else:
            pt = _p_tile(b, h, p, sm_count(x.device))
            err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                     B_.data_ptr(), C_.data_ptr(), init, y.data_ptr(),
                     state.data_ptr(), b, length, h, g, p, n, q, pt,
                     *strides, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError_t {err}")
    ssd_scan.launches += 1
    return y, state


def _plain(x, dt, A, B_, C_, q: int, initial_state, compute_dtype):
    """The CPU route: the sequential recurrence in float32, the chunked
    form (grouped B/C repeated to the heads) with bf16 compute."""
    if compute_dtype == torch.float32:
        return ssd_scan_ref(x, dt, A, B_, C_, chunk=q,
                            initial_state=initial_state)
    rep = x.shape[2] // B_.shape[2]
    return ssd_chunked(x, dt, A, B_.repeat_interleave(rep, 2),
                       C_.repeat_interleave(rep, 2), q,
                       initial_state=initial_state,
                       compute_dtype=compute_dtype)


def cost(b: int, length: int, h: int, p: int, n: int, g: int, q: int,
         dtype: torch.dtype, init: bool = False):
    """(flops, bytes) of the SSD scan, either compute dtype: x, B, C and
    dt read once (and the initial state, given one), y and the final
    state written once. Per (b, h, chunk) the flops are counted once: Q·N·Q
    for the causal C·Bᵀ scores, Q·P·Q for their product with x·dt and
    4·Q·N·P for the inter-chunk term and the state update (the float32
    compute's hi/lo pairs double the tensor-core work, not the
    function's flops)."""
    nbytes = ((2 * b * length * h * p + 2 * b * length * g * n)
              * dtype.itemsize + b * length * h * 4
              + b * h * n * p * 4 * (1 + int(init)))
    units = b * h * (length // q)
    flops = (float(q) * n * q + float(q) * p * q + 4.0 * q * n * p) * units
    return flops, nbytes


_op = oplib.define(
    "ssd_scan",
    "(Tensor x, Tensor dt, Tensor A, Tensor B, Tensor C, "
    "Tensor? initial_state, int q, ScalarType compute_dtype) "
    "-> (Tensor, Tensor)",
    cuda=lambda x, dt, A, B_, C_, s0, q, cdt: _kernel(x, dt, A, B_, C_, q,
                                                     s0, cdt),
    cpu=lambda x, dt, A, B_, C_, s0, q, cdt: _plain(x, dt, A, B_, C_, q, s0,
                                                   cdt),
    fake=lambda x, dt, A, B_, C_, s0, q, cdt: (
        x.new_empty(x.shape),
        x.new_empty((x.shape[0], x.shape[2], B_.shape[3], x.shape[3]),
                    dtype=torch.float32)),
    cost=lambda x, dt, A, B_, C_, s0, q, cdt: cost(
        *x.shape[:3], x.shape[3], B_.shape[3], B_.shape[2], q, x.dtype,
        s0 is not None))


class _SsdScan(torch.autograd.Function):
    """Forward through the operator (the kernel on the card); backward =
    the VJP of ``ssd_chunked`` at the same compute dtype, recomputed from
    the saved inputs (grouped B/C repeated to the heads, their gradients
    summed back to the groups)."""

    @staticmethod
    def forward(ctx, x, dt, A, B_, C_, initial_state, q, compute_dtype):
        ctx.save_for_backward(x, dt, A, B_, C_, initial_state)
        ctx.q, ctx.compute_dtype = q, compute_dtype
        ctx.set_materialize_grads(False)     # an unused output: None
        return _op(x, dt, A, B_, C_, initial_state, q, compute_dtype)

    @staticmethod
    def backward(ctx, dy, dstate):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(
                need) for t, need in zip(saved, ctx.needs_input_grad)]
            x, dt, A, B_, C_, s0 = ins
            rep = x.shape[2] // B_.shape[2]
            y, state = ssd_chunked(x, dt, A, B_.repeat_interleave(rep, 2),
                                   C_.repeat_interleave(rep, 2), ctx.q,
                                   initial_state=s0,
                                   compute_dtype=ctx.compute_dtype)
            # an output with no cotangent or that no input reaches (the
            # final state does not depend on C) adds nothing
            pairs = [(o, c) for o, c in ((y, dy), (state, dstate))
                     if c is not None and o.requires_grad]
            wrt = [t for t in ins if t is not None and t.requires_grad]
            outs, cots = zip(*pairs) if pairs else ((), ())
            grads = iter(torch.autograd.grad(outs, wrt, cots,
                                             allow_unused=True)
                         if pairs else [None] * len(wrt))
        return (*(next(grads) if t is not None and t.requires_grad else None
                  for t in ins), None, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, *, chunk: int = 128,
             initial_state: Optional[torch.Tensor] = None,
             compute_dtype="float32") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,L,H,P) float32/bfloat16, dt (B,L,H) float32, A (H,) float32,
    B_/C_ (B,L,G,N) in x's dtype -> (y (B,L,H,P) in x's dtype, final state
    (B,H,N,P) float32); differentiable (see the module docstring).
    ``compute_dtype``: "float32" or "bfloat16" (or the torch dtype).

    A CUDA tensor goes to the kernel ``route`` names (N <= 128, P a
    multiple of 16; bf16 compute the tensor-core route only; a failed build
    or launch raises); a CPU tensor goes to ``ssd_scan_ref``, or with bf16
    compute to ``ssd_chunked``. Each kernel launch adds one to
    ``ssd_scan.launches``.
    """
    q = _check(x, dt, A, B_, C_, chunk, initial_state)
    return _SsdScan.apply(x, dt, A, B_, C_, initial_state, q,
                          compute_dtype_of(compute_dtype))


ssd_scan.launches = 0
