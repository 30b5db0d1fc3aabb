"""Plain PyTorch version of the Poisson-bootstrap moment kernel.

Materialises each group's (n, B) Poisson weight matrix from the counter
PRNG (entry (j, b) = poisson1(hash3(seed, j, b)), j the ABSOLUTE slot) and
contracts it with the masked moment features in the kernel's exact order:
slots are cut into fixed CHUNK-slot chunks, each chunk's products are added
one slot at a time in ascending order (a separately rounded multiply, then
an add), and the chunk partials are added in ascending chunk order.  That
order depends only on absolute slot indices, so

* widening the slice with zero-mask slots (a wider width bucket) appends
  exact zeros and changes no bit;
* the CUDA kernel, which sums in the same order, matches this bit for bit;
* gated and ungated calls agree bitwise on active groups.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import prng

CHUNK = 256          # slots per fixed summation chunk (kernel's kChunk)
NUM_MOMENTS = 5      # [sum w, sum w x, sum w x^2, sum w x^3, sum w x^4]
_MAX_ELEMS = 1 << 24  # weight entries materialised at once


def build_feats(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(..., n, 5) masked moment features [m, mx, mx^2, mx^3, mx^4]."""
    x = x.to(torch.float32)
    m = mask.to(torch.float32)
    x2 = x * x
    mx2 = m * x2
    return torch.stack([m, m * x, mx2, mx2 * x, mx2 * x2], dim=-1)


def _moments(x: torch.Tensor, mask: torch.Tensor, seeds: torch.Tensor,
             B: int, start: int = 0) -> torch.Tensor:
    """(g, B, 5) replicate moment sums for ``g`` always-active groups whose
    slice begins at absolute slot ``start``."""
    g, n = x.shape
    C = -(-n // CHUNK)
    pad = C * CHUNK - n
    feats = build_feats(torch.nn.functional.pad(x, (0, pad)),
                        torch.nn.functional.pad(mask, (0, pad)))
    feats = feats.reshape(g, C, CHUNK, NUM_MOMENTS)
    dev = x.device
    rows = start + torch.arange(C * CHUNK, dtype=torch.int64, device=dev)
    cols = torch.arange(B, dtype=torch.int64, device=dev)
    W = prng.poisson1_weights_at(seeds[:, None, None], rows[None, :, None],
                                 cols[None, None, :])          # (g, n_pad, B)
    W = W.reshape(g, C, CHUNK, B)
    acc = torch.zeros((g, C, B, NUM_MOMENTS), dtype=torch.float32, device=dev)
    for j in range(CHUNK):
        acc = acc + W[:, :, j, :, None] * feats[:, :, j, None, :]
    total = torch.zeros((g, B, NUM_MOMENTS), dtype=torch.float32, device=dev)
    for c in range(C):
        total = total + acc[:, c]
    return total


def bootstrap_moments_masked_ref(x: torch.Tensor, mask: torch.Tensor,
                                 seeds: torch.Tensor, B: int,
                                 lane_active: Optional[torch.Tensor] = None,
                                 start: int = 0) -> torch.Tensor:
    """(..., B, 5) replicate moment sums of masked groups.

    ``x``/``mask`` are ``(..., n)``, ``seeds`` ``(...)`` uint32 patterns in an
    integer tensor, ``lane_active`` ``(...)`` gate flags (None = all on).
    Inactive groups do no work and report zeros.  ``start`` (a multiple of
    :data:`CHUNK`) is the absolute slot of the slice's first element: the
    sums equal those of the whole prefix ``[0, start + n)`` whenever the
    features below ``start`` are zero (masked finite values), because every
    chunk below it adds an exact zero.
    """
    if start % CHUNK:
        raise ValueError(f"start={start} must be a multiple of {CHUNK}")
    lead, n = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, n).to(torch.float32)
    mf = mask.reshape(-1, n).to(torch.float32)
    sf = seeds.reshape(-1).to(device=x.device, dtype=torch.int64) & prng.MASK32
    G = xf.shape[0]
    out = torch.zeros((G, B, NUM_MOMENTS), dtype=torch.float32,
                      device=x.device)
    if lane_active is None:
        idx = torch.arange(G, device=x.device)
    else:
        idx = torch.nonzero(lane_active.reshape(-1).to(x.device) != 0)[:, 0]
    per = max(1, _MAX_ELEMS // max(1, (-(-n // CHUNK)) * CHUNK * B))
    for s in range(0, idx.numel(), per):
        sel = idx[s:s + per]
        out[sel] = _moments(xf[sel], mf[sel], sf[sel], B, start)
    return out.reshape(tuple(lead) + (B, NUM_MOMENTS))
