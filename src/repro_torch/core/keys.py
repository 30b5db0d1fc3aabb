"""Host-side key derivation: Threefry-2x32 ``PRNGKey``/``fold_in``/``split``/
``bits`` in numpy.

The reference derives every lane seed and every slot->row binding from keys
made with ``jax.random`` (threefry with ``jax_threefry_partitionable``, the
default since jax 0.5).  The port has no JAX, so it reproduces that key
algebra bit for bit here.  Keys are ``(2,)`` uint32 numpy arrays; batches of
keys are ``(k, 2)``.  They are a handful of host integers per request, so
none of this runs on the card.
"""
from __future__ import annotations

import numpy as np

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
    lo = np.arange(1 if num is None else num, dtype=np.uint32)
    b0, b1 = threefry2x32(as_key(key), np.zeros_like(lo), lo)
    out = b0 ^ b1
    return int(out[0]) if num is None else out
