"""Counter-based PRNG shared by the bootstrap kernel and its plain version.

A murmur3-finalizer hash of (seed, row, col) gives stateless uniforms: the
CUDA kernel (``csrc/poisson_bootstrap.cu``) generates entry (row, col) of the
bootstrap weight matrix in registers, and the plain PyTorch version
materialises the very same matrix from these functions, so the two can be
compared exactly instead of only statistically.

The arithmetic is uint32 with wrapping semantics.  PyTorch on the CPU has no
right shift for ``uint32`` tensors, so every value is carried in an int64
tensor holding the uint32 bit pattern (0 <= v < 2**32): the low 32 bits of a
wrapped int64 product are the uint32 product, and a right shift of a
non-negative int64 is the logical shift.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: full avalanche on 32 bits."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & MASK32
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & MASK32
    return h ^ (h >> 16)


def hash3(seed, row, col) -> torch.Tensor:
    """Stateless uniform bits for matrix entry (row, col) under ``seed``:
    uint32 patterns in int64 tensors or Python ints, broadcasting."""
    h = (((row * 0x9E3779B1) & MASK32) ^ ((col * 0x85EBCA77) & MASK32)
         ^ ((seed * 0xC2B2AE3D) & MASK32))
    return mix32(h)


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> f32 uniform in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


# Poisson(1) CDF ladder P(X <= k), k = 0..9; identical to the reference's.
POISSON1_CDF = (
    0.36787944117144233, 0.7357588823428847, 0.9196986029286058,
    0.9810118431238462, 0.9963401531726563, 0.9994058151824183,
    0.9999167588507119, 0.9999897508033253, 0.9999988747974149,
    0.9999998885745217,
)
# The thresholds as f32, the precision the comparisons run at.
POISSON1_CDF_F32 = tuple(float(np.float32(c)) for c in POISSON1_CDF)


def poisson1_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF Poisson(1) counts from f32 uniforms (truncated at 10)."""
    w = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for c in POISSON1_CDF_F32:
        w = w + (u >= c).to(torch.float32)
    return w


def poisson1_weights_at(seed, row, col) -> torch.Tensor:
    """Weight matrix entry (row, col) = Poisson(1) draw."""
    return poisson1_from_uniform(uniform01(hash3(seed, row, col)))
