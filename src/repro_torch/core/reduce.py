"""Fixed-order reductions.

``torch.sum`` picks its summation order from the tensor's size and device,
so a sum over a zero-padded, wider view of the same values can round
differently, and the CPU and the card can disagree in the last bit.  The
fused loop's invariants (bucket-width invariance, pool lane == solo run, the
card's trajectory == the CPU's) need sums whose order is fixed by the data
alone.  :func:`tree_sum` is a pairwise tree over the axis padded with zeros to
a power of two: appending zeros leaves every partial sum unchanged, and each
level is one elementwise add, which rounds the same on every device.
"""
from __future__ import annotations

import torch


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Pairwise sum over ``dim`` in a fixed, width-invariant order."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    p = 1 << (n - 1).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]
