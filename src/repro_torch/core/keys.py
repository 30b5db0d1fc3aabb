"""Threefry-2x32 key derivation and draws: ``PRNGKey``/``fold_in``/``split``/
``bits`` and the ``uniform``/``randint``/``normal`` draws of ``jax.random``.

The reference derives every lane seed, every slot->row binding and the host
route's bootstrap weights from keys made with ``jax.random`` (threefry with
``jax_threefry_partitionable``, the default since jax 0.5).  The port has no
JAX, so it reproduces that key algebra and those draws here.  Keys are
``(2,)`` uint32 numpy arrays; batches of keys are ``(k, 2)``.

Entry ``i`` (row-major) of a draw of shape ``s`` hashes the counter pair
``(i >> 32, i & 0xFFFFFFFF)``.  Key derivation and small draws run in numpy
on the host.  Bulk draws (the ``(B, n)`` bootstrap uniforms, the ``(m,
n_cap)`` stratified-sample uniforms) pass a ``device`` and run as torch ops
there, on int64 tensors holding uint32 patterns (PyTorch has no logical
right shift for uint32 on the CPU).

``uniform`` and ``randint`` equal ``jax.random``'s bit for bit.  ``normal``
goes through XLA's f32 ``erf_inv`` polynomial; ``log1p`` and the order of
its f32 operations may round differently, so it is held to the reference
within a stated tolerance (``tests/test_torch_host_keys.py``).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter pair ``(x0, x1)``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed in the int32 range."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is outside the int32 range")
    return np.asarray([0, seed & 0xFFFFFFFF], np.uint32)


def as_key(key) -> np.ndarray:
    """A ``(2,)`` uint32 key from anything array-like."""
    k = np.asarray(key).astype(np.uint32)
    if k.shape != (2,):
        raise ValueError(f"a key has shape (2,), got {k.shape}")
    return k


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    b0, b1 = threefry2x32(as_key(key), np.zeros((1,), np.uint32),
                          np.asarray([int(data) & 0xFFFFFFFF], np.uint32))
    return np.asarray([b0[0], b1[0]], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: a ``(num, 2)`` batch of keys."""
    lo = np.arange(num, dtype=np.uint32)
    b0, b1 = threefry2x32(as_key(key), np.zeros_like(lo), lo)
    return np.stack([b0, b1], axis=1)


def bits(key, num: int | None = None):
    """``jax.random.bits(key, shape, uint32)`` for shape ``()`` (returns an
    int) or ``(num,)`` (returns a uint32 array)."""
    out = random_bits(key, 1 if num is None else num)
    return int(out[0]) if num is None else out


# ---------------------------------------------------------------------------
# draws of a shape: ``jax.random.bits`` / ``uniform`` / ``randint`` / ``normal``
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(
        int(d) for d in shape)


def _threefry_t(key: np.ndarray, x0: torch.Tensor,
                x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`threefry2x32` on int64 tensors holding uint32 patterns."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = (((x1 << r) & _MASK32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & _MASK32)) & _MASK32
    return x0, x1


def random_bits(key, shape: Shape, device=None):
    """``jax.random.bits(key, shape, uint32)``: a uint32 numpy array, or with
    ``device`` an int64 tensor of uint32 patterns on that device."""
    shape = _shape(shape)
    key = as_key(key)
    size = math.prod(shape)
    if device is None:
        i = np.arange(size, dtype=np.uint64)
        b0, b1 = threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                              (i & np.uint64(_MASK32)).astype(np.uint32))
        return (b0 ^ b1).reshape(shape)
    i = torch.arange(size, dtype=torch.int64, device=device)
    b0, b1 = _threefry_t(key, i >> 32, i & _MASK32)
    return (b0 ^ b1).reshape(shape)


def _unit_floats(bits):
    """f32 in [0, 1) from uint32 bits: mantissa ``bits >> 9`` under the
    exponent of 1.0, minus 1 (jax's construction, exact)."""
    if not isinstance(bits, torch.Tensor):
        bits = np.asarray(bits)
        f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
        return f - np.float32(1.0)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, shape: Shape = (), minval: float = 0.0, maxval: float = 1.0,
            device=None):
    """``jax.random.uniform(key, shape, float32, minval, maxval)``:
    ``max(minval, floats * (maxval - minval) + minval)`` in f32."""
    f = _unit_floats(random_bits(key, shape, device))
    lo, hi = np.float32(minval), np.float32(maxval)
    span = np.float32(hi - lo)
    if not isinstance(f, torch.Tensor):
        return np.maximum(lo, f * span + lo)
    return torch.clamp(f * float(span) + float(lo), min=float(lo))


def randint(key, shape: Shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32) on the host:
    two words of bits from ``split(key)``, reduced modulo the span in uint32
    arithmetic with wrap-around, as jax's ``_randint`` does."""
    lo = int(np.clip(minval, -2 ** 31, 2 ** 31 - 1))
    hi_raw = int(maxval)
    hi = int(np.clip(hi_raw, -2 ** 31, 2 ** 31 - 1))
    k1, k2 = split(key, 2)
    higher = random_bits(k1, shape).astype(np.uint64)
    lower = random_bits(k2, shape).astype(np.uint64)
    span = (hi - lo) & _MASK32
    if hi <= lo:
        span = 1
    elif hi_raw > 2 ** 31 - 1:
        span = (span + 1) & _MASK32
    span = np.uint64(span)
    if span == 0:           # 2**32: XLA's x % 0 is x, so the low word
        off = lower
    else:
        mult = np.uint64((1 << 16) % int(span))
        mult = (mult * mult) & np.uint64(_MASK32)
        mult = mult % span
        off = ((higher % span) * mult) & np.uint64(_MASK32)
        off = ((off + lower % span) & np.uint64(_MASK32)) % span
    out = (np.int64(lo) + off.astype(np.int64)) & np.int64(_MASK32)
    return out.astype(np.uint32).view(np.int32).reshape(_shape(shape))


# XLA's f32 erf_inv (Giles' single-precision polynomial): w = -log1p(-x^2),
# degree-9 Horner in w - 2.5 below 5 and in sqrt(w) - 3 above.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


# XLA's f32 log1p below |x| < sqrt(2) - 1: Cephes' rational form
# x + (-0.5 x^2 + x^3 P(x) / Q(x)), numerator and denominator by Horner.
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA CPU's f32 log (Cephes' logf on the mantissa in [sqrt(1/2), sqrt(2))).
_LOGF_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
           -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
           2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOGF_Q1, _LOGF_Q2 = -2.12194440e-4, 0.693359375


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 fused multiply-add, ``a * b + c`` rounded once (through float64:
    the product of two f32 values is exact there).  ``b`` and ``c`` are f32
    tensors on ``a``'s device or Python floats holding f32 values."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    """f32 Horner evaluation, each step one fused multiply-add: the product
    of two f32 values is exact in float64, so one float64 add and the
    rounding to f32 give the FMA's value."""
    x64 = x.double()
    p = torch.full_like(x64, float(np.float32(coeffs[0])))
    for c in coeffs[1:]:
        p.mul_(x64).add_(float(np.float32(c)))
        p.copy_(p.float())
    return p.float()


def log_f32(a: torch.Tensor) -> torch.Tensor:
    """f32 natural log as XLA compiles it for the CPU: Cephes' ``logf``
    with its polynomial in three fused Horner strands.  Bit-equal to
    ``jnp.log``, subnormals flushed to zero: 0 -> -inf, negatives -> NaN."""
    a = _flush(a)
    tiny = float(np.finfo(np.float32).tiny)
    x = torch.clamp(a, min=tiny)
    bits = x.view(torch.int32)
    e = (((bits >> 23) - 0x7F).to(torch.float32) + 1.0)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [.5, 1)
    low = m < float(np.float32(0.707106781186547524))
    t = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.to(torch.float32)
    x2 = t * t
    x3 = x2 * t
    p = [float(np.float32(c)) for c in _LOGF_P]
    y = _fma(_fma(t, p[0], p[1]), t, p[2])
    y1 = _fma(_fma(t, p[3], p[4]), t, p[5])
    y2 = _fma(_fma(t, p[6], p[7]), t, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, float(np.float32(_LOGF_Q1)) * e)
    t = (t - 0.5 * x2) + y
    t = t + float(np.float32(_LOGF_Q2)) * e
    t = torch.where(a == 0, torch.full_like(t, -float("inf")), t)
    t = torch.where(a == float("inf"), a, t)
    return torch.where(a < 0, torch.full_like(t, float("nan")), t)


def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``log1p`` as XLA compiles it for the CPU: Cephes' rational form
    below ``|x| < sqrt(2) - 1``, :func:`log_f32` of ``1 + x`` above.
    Bit-equal to ``jnp.log1p`` on the CPU, which flushes subnormal
    arguments to (signed) zero."""
    x = _flush(x)
    return torch.where(x.abs() < LOG1P_SMALL, _log1p_small(x),
                       log_f32(x + 1.0))


def _flush(x: torch.Tensor) -> torch.Tensor:
    """Subnormals to zero, sign kept (XLA's CPU flush-to-zero)."""
    return torch.where(x.abs() < float(np.finfo(np.float32).tiny), x * 0.0,
                       x)


LOG1P_SMALL = float(np.float32(0.41421356237309504880))   # sqrt(2) - 1


def _log1p_small(x: torch.Tensor) -> torch.Tensor:
    """The rational branch of :func:`log1p_f32` (``|x| < sqrt(2) - 1``)."""
    xs = x * x
    r = _horner(_LOG1P_P, x) / _horner(_LOG1P_Q, x)
    return x + (-0.5 * xs + (x * xs) * r)


# XLA CPU's f32 exp: Cephes' expf reduction and polynomial (the last
# coefficient rounded to 0.5 in f32), every multiply-add fused.
_EXP_HI = float(np.float32(88.8))
_EXP_LOG2E = float(np.float32(1.44269504088896341))
_EXP_C1, _EXP_C2 = float(np.float32(0.693359375)), float(
    np.float32(-2.12194440e-4))
_EXP_P = tuple(float(np.float32(c)) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 0.5))


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``exp`` of a non-negative tensor as XLA compiles it for the CPU
    (the machine code of a jitted ``jnp.exp``): ``n = floor(fma(x, log2 e,
    1/2))`` clamped to 127, ``r = x - n C1 - n C2`` as two fused steps, a
    fused Horner polynomial ``y`` in ``r``, ``fma(y, r*r, r) + 1`` times
    ``2**n``.  Bit-equal to ``jnp.exp`` on the CPU for ``0 <= x <= 88.8``
    (its lower clamp and its negative range are not needed here); not
    correctly rounded, so torch's ``exp`` differs in ~9 % of values."""
    x = torch.clamp(x.to(torch.float32), max=_EXP_HI)
    n = torch.clamp(torch.floor(_fma(x, _EXP_LOG2E, 0.5)), max=127.0)
    r = _fma(n, -_EXP_C1, x)
    r = _fma(n, -_EXP_C2, r)
    y = torch.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return y * scale


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """f32 inverse error function by XLA's polynomial (+-inf at +-1), its
    Horner steps fused as XLA's CPU code fuses them.  Bit-equal to
    ``jax.scipy.special.erfinv`` where ``w < 5`` (|x| below ~0.9966); above
    it up to 2 ulps apart in ~2 % of arguments (ROADMAP Queue 3 item 2)."""
    w = -log1p_f32(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, torch.where(lt, a, b).to(torch.float32))
    out = p * x
    return torch.where(x.abs() == 1.0, x * float(np.finfo(np.float32).max),
                       out)


def normal(key, shape: Shape, device=None):
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) *
    erf_inv(uniform(key, shape, -1 + ulp, 1))``, bit for bit except in
    the tails of :func:`erf_inv` (|normal| above ~4.1, at most 2 ulps).  A
    tensor on ``device`` (the CPU when None)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device=device if device is not None
                else "cpu")
    return float(np.float32(np.sqrt(2.0))) * erf_inv(u)
