"""``jax.random``'s threefry2x32 draws in plain torch: the keys, bits,
uniforms and truncated normals that the JAX package's model initializers
take, so that one seed gives the reference's initial weights.

A key is a tensor of two uint32 words held in int64, ``[hi, lo]``, as
``jax.random.PRNGKey`` makes it; it lives on a device, and every draw from
it runs on that device (the card, the CPU, or ``meta``, where nothing is
drawn), like a ``torch.Generator``'s. Each function follows jax 0.9 with
``jax_threefry_partitionable=True`` (its default):

- ``threefry2x32``: the 20-round Threefry-2x32 hash (rotations 13, 15,
  26, 6 and 17, 29, 16, 24; key schedule with ``0x1BD11BDA``), here on
  int32 words whose adds wrap, with logical shifts masked by hand;
- ``split`` and ``bits``: the hash of each element's row-major flat index
  as the counter words (hi, lo); ``split`` keeps both output words, ``bits``
  their xor;
- ``uniform``: the top 23 bits as the mantissa of a float in [1, 2), minus
  1, scaled and shifted by one fused multiply-add, then ``max(minval, ·)``;
- ``truncated_normal``: ``sqrt(2)·erf_inv(u)`` on a uniform between
  ``erf(lower/√2)`` and ``erf(upper/√2)``, clipped to the open interval.

The floating-point steps are XLA's CPU code for float32 ``erf``,
``log1p`` (Eigen's ``plog``) and ``erf_inv`` (Giles' polynomial), with the
fused multiply-adds that XLA's CPU backend emits. A fused multiply-add is
computed in float64 and rounded to float32: the product of two float32
values is exact in float64, so this differs from one rounding only where
the float64 sum lands on a float32 tie, about once in 2^29 operations, and
then by one ulp. So a draw equals jax's bit for bit but for those ties
(none in the draws ``tests/test_torch_random.py`` and
``tests/test_torch_init_parity.py`` make). Every step here is a correctly
rounded IEEE operation — the float32 quotient and square root are taken in
float64 and rounded, since torch's own need not be (its CPU float32 sqrt
is not always) — so the card draws the CPU's bits.

A large draw is written into its output chunk by chunk along the flat
index (``CHUNK`` elements at a time), so the temporaries stay small beside
the tensor itself (a DeepSeek-V3 expert stack is 15 GB as float32).
"""
from __future__ import annotations

import functools
import math
import struct
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["PRNGKey", "threefry2x32", "split", "bits", "uniform",
           "truncated_normal"]

# elements drawn at a time, by device type. On the CPU at most torch's
# grain size (32,768), so each of a chunk's ~330 ops runs on the calling
# thread: a parallel region an op stalls at every barrier on a loaded CPU
# (a reduced zoo init took minutes so). On the card a launch has work
# enough.
CHUNK = {"cpu": 1 << 15, "cuda": 1 << 22}

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def PRNGKey(seed: int, device: DeviceLike = None) -> torch.Tensor:
    """The key ``[seed >> 32, seed & 0xFFFFFFFF]`` (two uint32 words in
    int64) on ``device`` (None: the GPU, raising without CUDA), as
    ``jax.random.PRNGKey(seed)`` gives it for a seed below 2^32, and for
    any seed under ``jax_enable_x64`` (with x64 off jax keeps the low
    word alone)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64, device=resolve_device(device))


# ---------------------------------------------------------------------- #
# The hash on int32 words
# ---------------------------------------------------------------------- #
def _to_i32(words: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 -> the same 32 bits as int32."""
    return (words - ((words >> 31) << 32)).to(torch.int32)


def _to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 -> its bits as a uint32 word held in int64."""
    return x.to(torch.int64) & _M32


def _rotl_(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate the int32 words ``x`` left by ``r``, in place: ``>>`` on
    int32 copies the sign bit, so the low ``r`` bits are masked out."""
    t = x << r
    x >>= 32 - r
    x &= (1 << r) - 1
    x |= t
    return x


def _hash_(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 (20 rounds) of the counter words ``x0``, ``x1``
    (int32, overwritten) under ``key``: the two output words, int32."""
    k = _to_i32(key)
    ks = (k[0], k[1], k[0] ^ k[1] ^ 0x1BD11BDA)
    x0 += ks[0]
    x1 += ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            _rotl_(x1, r)
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + (i + 1)
    return x0, x1


def threefry2x32(key: torch.Tensor, hi: torch.Tensor,
                 lo: torch.Tensor):
    """The Threefry-2x32 hash of the counter words (``hi``, ``lo``: uint32
    words held in int64, one shape) under ``key``: its two output words,
    as jax's ``threefry2x32_p`` gives them, on the key's device."""
    x0, x1 = _hash_(key, _to_i32(hi.to(key.device)),
                    _to_i32(lo.to(key.device)))
    return _to_u32(x0), _to_u32(x1)


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(d) for d in shape)


def _counters(start: int, stop: int, device) -> tuple:
    """The int32 counter words (hi, lo) of the flat indices [start,
    stop)."""
    idx = torch.arange(start, stop, dtype=torch.int64, device=device)
    return _to_i32(idx >> 32), _to_i32(idx & _M32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys, (num, 2), as ``jax.random.split(key, num)``."""
    if key.device.type == "meta":
        return torch.empty((num, 2), dtype=torch.int64, device="meta")
    x0, x1 = _hash_(key, *_counters(0, num, key.device))
    return torch.stack([_to_u32(x0), _to_u32(x1)], dim=-1)


def _bits_i32(key: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """The 32 random bits of the flat indices [start, stop), int32."""
    x0, x1 = _hash_(key, *_counters(start, stop, key.device))
    return x0.bitwise_xor_(x1)


def _fill(key: torch.Tensor, shape: Shape, dtype: torch.dtype,
          chunk_fn) -> torch.Tensor:
    """A tensor of ``shape`` and ``dtype`` on the key's device, written
    chunk by chunk: ``chunk_fn(start, stop)`` gives its flat elements
    [start, stop). On ``meta``, an empty tensor."""
    shape = _shape(shape)
    out = torch.empty(shape, dtype=dtype, device=key.device)
    if key.device.type == "meta":
        return out
    flat = out.view(-1)
    n, step = flat.numel(), CHUNK[out.device.type]
    for start in range(0, n, step):
        stop = min(start + step, n)
        flat[start:stop] = chunk_fn(start, stop)
    return out


def bits(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """32 random bits an element, as uint32 words held in int64: jax's
    ``jax.random.bits(key, shape)``."""
    return _fill(key, shape, torch.int64,
                 lambda a, b: _to_u32(_bits_i32(key, a, b)))


# ---------------------------------------------------------------------- #
# Float32 steps, in XLA's CPU order
# ---------------------------------------------------------------------- #
def _f32(x: float) -> float:
    """``x`` rounded to float32 (as a Python float)."""
    return float(np.float32(x))


def _hex32(h: str) -> float:
    """A float32 constant written as LLVM IR writes it (the double's hex
    bits)."""
    return _f32(struct.unpack(">d", bytes.fromhex(h))[0])


@functools.lru_cache(maxsize=None)
def _const(value: float, device: torch.device) -> torch.Tensor:
    """``value`` as a float64 tensor of shape (1,) on ``device``, made
    once: as an operand it makes float64 the common dtype of an op on
    float32 tensors (a 0-d tensor would not), and one made at every call
    would be copied to the card and waited for."""
    # repro: allow(dtype-f64)
    return torch.tensor([value], dtype=torch.float64, device=device)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a·b + c with one rounding but on a float64 tie (module
    doc): one ``addcmul`` computing in float64 — where the product of two
    float32 values is exact — and storing float32. ``a`` a float32
    tensor, ``b`` and ``c`` float32 tensors or floats."""
    b = _const(b, a.device) if not torch.is_tensor(b) else b
    # repro: allow(dtype-f64)
    c = _const(c, a.device) if not torch.is_tensor(c) else c.double()
    return torch.addcmul(c, a, b, out=torch.empty_like(a))


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 a / b, correctly rounded on every device: the float64
    quotient of two float32 values rounds to the float32 one (the card's
    float32 division and square root need not be IEEE's)."""
    # repro: allow(dtype-f64)
    return a.double().div_(b).float()


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    """float32 sqrt(a), correctly rounded on every device (as ``_div``)."""
    # repro: allow(dtype-f64)
    return a.double().sqrt_().float()


def _horner(x, coeffs) -> torch.Tensor:
    """c0·x^n + ... + cn by fused multiply-adds from c0: each element's
    coefficients are the columns of ``coeffs`` (floats, or per-element
    tensors)."""
    p = coeffs[0]
    if not torch.is_tensor(p):
        p = torch.full_like(x, p)
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


# XLA's float32 erf: clamped to +-3.832506856900711's float32 neighbour,
# a degree-9 odd numerator over a degree-12 even denominator
_ERF_CLAMP = _hex32("400DF38D00000000")
_ERF_ALPHA = [_hex32(h) for h in ("3F2E05AA20000000", "3F6BEBB440000000",
                                  "3FAA16DD60000000", "3FC7B4E800000000",
                                  "3FF20DD740000000")]
_ERF_BETA = [_hex32(h) for h in ("BE7FA720C0000000", "3EF8B11BE0000000",
                                 "3F50ADA500000000", "3F8CD0FA80000000",
                                 "3FBC698420000000", "3FDFD68940000000")] \
    + [1.0]


def _erf(x: float) -> float:
    """XLA's float32 erf of the float32 ``x``, as a float."""
    t = torch.tensor([x], dtype=torch.float32).clamp(-_ERF_CLAMP,
                                                     _ERF_CLAMP)
    t2 = t * t
    return float(_div(t * _horner(t2, _ERF_ALPHA), _horner(t2, _ERF_BETA)))


# Eigen's plog_float (XLA's CPU log of 1 + x, for |x| >= sqrt(2) - 1)
_LOG_P = [_hex32(h) for h in ("3FB2043760000000", "BFBD7A3700000000",
                              "3FBDE4A340000000", "BFBFCBA9E0000000",
                              "3FC23D37E0000000", "BFC555CA00000000",
                              "3FC999D580000000", "BFCFFFFF80000000",
                              "3FD5555540000000")]
_LOG_Q1 = _hex32("BF2BD01060000000")
_LOG_Q2 = _hex32("3FE6300000000000")
_SQRT_HALF = _hex32("3FE6A09E60000000")
# Cephes' rational log1p (for |x| < sqrt(2) - 1)
_LOG1P_SMALL = _hex32("3FDA8279A0000000")
_LOG1P_NUM = [_f32(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969e0, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1)]
_LOG1P_DEN = [1.0] + [_f32(c) for c in (
    1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1)]


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p of ``x`` > -1 (finite)."""
    # large |x|: Eigen's log of v = 1 + x, v = m·2^e with m in [0.5, 1)
    v = (x + 1.0).clamp_min_(2.0 ** -126)
    vb = v.view(torch.int32)
    e = ((vb >> 23) - 127).float() + 1.0
    m = ((vb & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _SQRT_HALF
    z = (m - 1.0) + m * low      # XLA's select(low, m, 0): m > 0
    e = e - low.float()
    z2 = z * z
    z3 = z2 * z
    y = _fma(z, _LOG_P[0], _LOG_P[1])
    y1 = _fma(z, _LOG_P[3], _LOG_P[4])
    y2 = _fma(z, _LOG_P[6], _LOG_P[7])
    y = _fma(y, z, _LOG_P[2])
    y1 = _fma(y1, z, _LOG_P[5])
    y2 = _fma(y2, z, _LOG_P[8])
    y = _fma(_fma(y, z3, y1), z3, y2)
    y = _fma(y, z3, e * _LOG_Q1)
    large = ((z - z2 * 0.5) + y) + e * _LOG_Q2    # e·q2 and z2/2 are exact
    # small |x|: x - x²/2 + x³·P(x)/Q(x)
    x2 = x * x
    r = _div(_horner(x, _LOG1P_NUM), _horner(x, _LOG1P_DEN))
    small = x + (x2 * -0.5 + (x * x2) * r)
    return torch.where(x.abs() < _LOG1P_SMALL, small, large)


# Giles' single-precision erfinv, XLA's ErfInv32
_ERFINV_LT5 = [_f32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941)]
_ERFINV_GE5 = [_f32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)]


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv of ``x`` in [-1, 1]."""
    w = -_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
    p = torch.where(lt, _horner(w, _ERFINV_LT5), _horner(w, _ERFINV_GE5))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def _unit_floats(b: torch.Tensor) -> torch.Tensor:
    """int32 random bits -> float32 in [0, 1): the top 23 bits as the
    mantissa of a float in [1, 2), minus 1."""
    b >>= 9
    b &= 0x7FFFFF
    b |= 0x3F800000
    return b.view(torch.float32) - 1.0


def _uniform_chunk(key, start, stop, lo: float, hi: float) -> torch.Tensor:
    f = _unit_floats(_bits_i32(key, start, stop))
    return _fma(f, _f32(hi - lo), lo).clamp_min_(lo)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval): jax's
    ``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = _f32(minval), _f32(maxval)
    return _fill(key, shape, torch.float32,
                 lambda a, b: _uniform_chunk(key, a, b, lo, hi))


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape: Shape = (), *, scale: float = 1.0,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """float32 standard normals truncated to the open interval (lower,
    upper): jax's ``jax.random.truncated_normal(key, lower, upper, shape,
    float32)``. The port's two keywords act after the draw, chunk by
    chunk, so that the float32 draw of a low-precision leaf never exists
    whole: each value times ``scale`` in float32 (jnp's ``scale * draw``
    for a float32 ``scale``), then cast to ``dtype``."""
    sqrt2 = _f32(math.sqrt(2.0))
    lo, hi = _f32(lower), _f32(upper)
    a = _erf(float(np.float32(lo) / np.float32(sqrt2)))
    b = _erf(float(np.float32(hi) / np.float32(sqrt2)))
    clip_lo = float(np.nextafter(np.float32(lo), np.float32(np.inf)))
    clip_hi = float(np.nextafter(np.float32(hi), np.float32(-np.inf)))
    scale = _f32(scale)

    def chunk(start, stop):
        z = _erf_inv(_uniform_chunk(key, start, stop, a, b)) * sqrt2
        z = z.clamp_(clip_lo, clip_hi)
        if scale != 1.0:
            z *= scale
        return z.to(dtype)
    return _fill(key, shape, dtype, chunk)
