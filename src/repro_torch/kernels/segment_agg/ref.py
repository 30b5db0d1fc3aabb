"""Plain PyTorch versions of the two segment kernels (``csrc/segment_agg.cu``).

Each adds in its kernel's exact order, with separately rounded multiplies
and adds, so a kernel and its plain version agree bit for bit:

* **exact aggregate** (:func:`segment_aggregate_ref`): the stream is cut
  into tiles of ``AGG_TILE = AGG_THREADS * AGG_PER_THREAD`` elements, one
  CUDA block each.  Thread t of a tile adds the features of its elements t,
  t + 128, t + 256, ... in that order into its own per-group sums; a group's
  128 thread sums are folded into 32 lane sums (lane l adds threads l, l +
  32, l + 64, l + 96 in order) and the lanes by a halving tree (lane l plus
  lane l + 16, then l + 8, ...: the warp's xor butterfly); the tiles' sums
  are folded the same way (lane l adds tiles l, l + 32, ... in order, then
  the halving tree).  Min and max are exact in any order.
* **segment bootstrap** (:func:`segment_bootstrap_sorted_ref`): the packed
  stream, sorted by lane and by slot within a lane, is cut by ABSOLUTE slot
  into ``CHUNK = 256``-slot chunks; a chunk's products are added one
  element at a time in stream order and a lane's chunk partials in
  ascending chunk order.  That is the Poisson-bootstrap kernel's order for
  the same slots (``kernels/poisson_bootstrap/ref.py``), so a grouped-block
  lane's replicate sums equal its solo run's bit for bit.

Adding an exact zero never changes a sum here (no sum is ever -0), so both
versions may skip or add the zeros of masked-out elements and empty
chunks alike.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from .. import prng

CHUNK = 256              # slots per summation chunk (kernel's kChunk)
NUM_MOMENTS = 3          # [sum w, sum w x, sum w x^2]
AGG_THREADS = 128        # threads per aggregate block (kernel's kAggThreads)
AGG_PER_THREAD = 256     # elements each aggregate thread adds
AGG_TILE = AGG_THREADS * AGG_PER_THREAD
WARP = 32
AGG_KEYS = ("count", "sum", "sumsq", "sum3", "sum4")
BIG = 3.0e38             # min/max of an empty group, as the reference's
_MAX_ELEMS = 1 << 24     # transient entries materialised at once


def aggregate_features(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(n, 5) masked power features [w, w x, w x^2, w x^3, w x^4]."""
    x = x.to(torch.float32)
    w = mask.to(torch.float32)
    x2 = x * x
    wx2 = w * x2
    return torch.stack([w, w * x, wx2, wx2 * x, wx2 * x2], dim=-1)


def _halving(s: torch.Tensor, dim: int) -> torch.Tensor:
    """Fold a power-of-two axis by halves (the warp's xor butterfly)."""
    while s.shape[dim] > 1:
        h = s.shape[dim] // 2
        s = s.narrow(dim, 0, h) + s.narrow(dim, h, h)
    return s.squeeze(dim)


def _lane_fold(v: torch.Tensor) -> torch.Tensor:
    """(r, k*32, ...) -> (r, ...): lane l adds entries l, l + 32, ... in
    order from zero, then the halving tree over the 32 lanes."""
    r, n = v.shape[0], v.shape[1]
    v = v.reshape((r, n // WARP, WARP) + tuple(v.shape[2:]))
    s = torch.zeros((r, WARP) + tuple(v.shape[3:]), dtype=v.dtype,
                    device=v.device)
    for j in range(v.shape[1]):
        s = s + v[:, j]
    return _halving(s, 1)


def segment_aggregate_ref(gid: torch.Tensor, x: torch.Tensor,
                          mask: torch.Tensor, m: int
                          ) -> Dict[str, torch.Tensor]:
    """Per-group count/sum/sumsq/sum3/sum4/min/max, each ``(m,)``.

    Sums weight each power by ``mask``; min/max range over elements with
    ``mask > 0``; elements whose ``gid`` lies outside ``[0, m)`` belong to
    no group.  An empty group reads min ``3e38`` and max ``-3e38``.
    """
    dev = x.device
    n = x.shape[0]
    gid = gid.to(device=dev, dtype=torch.int64)
    w = mask.to(torch.float32)
    x = x.to(torch.float32)
    in_range = (gid >= 0) & (gid < m)
    feats = torch.where((in_range & (w != 0))[:, None],
                        aggregate_features(x, w), 0.0)
    g = torch.where(in_range, gid, -1)
    nb = max(1, -(-n // AGG_TILE))
    pad = nb * AGG_TILE - n
    feats = torch.nn.functional.pad(feats, (0, 0, 0, pad))
    feats = feats.reshape(nb, AGG_PER_THREAD, AGG_THREADS, 5)
    g = torch.nn.functional.pad(g, (0, pad), value=-1).reshape(
        nb, AGG_PER_THREAD, AGG_THREADS)
    groups = torch.arange(m, device=dev)
    tiles = torch.zeros((nb, m, 5), dtype=torch.float32, device=dev)
    per = max(1, _MAX_ELEMS // (AGG_THREADS * m * 5))
    for s in range(0, nb, per):
        e = min(nb, s + per)
        acc = torch.zeros((e - s, AGG_THREADS, m, 5), dtype=torch.float32,
                          device=dev)
        for k in range(AGG_PER_THREAD):
            hit = g[s:e, k, :, None] == groups                 # (t, T, m)
            acc = acc + torch.where(hit[..., None],
                                    feats[s:e, k, :, None, :], 0.0)
        tiles[s:e] = _lane_fold(acc)
    nb32 = -(-nb // WARP) * WARP
    tiles = torch.nn.functional.pad(tiles, (0, 0, 0, 0, 0, nb32 - nb))
    sums = _lane_fold(tiles.reshape(1, nb32, m, 5))[0]          # (m, 5)
    live = in_range & (w > 0)
    gc = torch.where(in_range, gid, 0)
    mn = torch.full((m,), BIG, dtype=torch.float32, device=dev).scatter_reduce(
        0, gc, torch.where(live, x, BIG), "amin")
    mx = torch.full((m,), -BIG, dtype=torch.float32, device=dev).scatter_reduce(
        0, gc, torch.where(live, x, -BIG), "amax")
    out = {k: sums[:, i] for i, k in enumerate(AGG_KEYS)}
    out["min"], out["max"] = mn, mx
    return out


def boot_features(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(L, 3) features [m, m x, m x^2] of the elements with ``mask > 0``
    (exact zeros elsewhere), as the Poisson-bootstrap kernel forms them."""
    x = x.to(torch.float32)
    m = mask.to(torch.float32)
    f = torch.stack([m, m * x, m * (x * x)], dim=-1)
    return torch.where((m > 0)[:, None], f, 0.0)


def segment_bootstrap_sorted_ref(x: torch.Tensor, mask: torch.Tensor,
                                 slot: torch.Tensor, seed: torch.Tensor,
                                 lane_off: torch.Tensor, B: int,
                                 n_slots: int) -> torch.Tensor:
    """(q, B, 3) replicate moment sums of a packed stream SORTED by lane and
    by slot within a lane: lane g owns elements ``[lane_off[g],
    lane_off[g + 1])``, every slot is below ``n_slots``, and weight (j, b)
    is ``poisson1(hash3(seed_j, slot_j, b))``."""
    dev = x.device
    q = lane_off.shape[0] - 1
    L = x.shape[0]
    out = torch.zeros((q, B, NUM_MOMENTS), dtype=torch.float32, device=dev)
    if L == 0 or q == 0:
        return out
    C = -(-int(n_slots) // CHUNK)
    pos = torch.arange(L, device=dev)
    lane = torch.searchsorted(lane_off[1:].to(torch.int64), pos, right=True)
    slot = slot.to(torch.int64)
    key = lane * C + slot // CHUNK
    uniq, inv, cnt = torch.unique_consecutive(key, return_inverse=True,
                                              return_counts=True)
    rank = pos - (torch.cumsum(cnt, 0) - cnt)[inv]
    K, R = uniq.shape[0], int(cnt.max())
    fd = torch.zeros((K, R, NUM_MOMENTS), dtype=torch.float32, device=dev)
    fd[inv, rank] = boot_features(x, mask)
    sd = torch.zeros((K, R), dtype=torch.int64, device=dev)
    sd[inv, rank] = slot
    ed = torch.zeros((K, R), dtype=torch.int64, device=dev)
    ed[inv, rank] = seed.to(torch.int64) & prng.MASK32
    cols = torch.arange(B, dtype=torch.int64, device=dev)[None, :]
    acc = torch.zeros((K, B, NUM_MOMENTS), dtype=torch.float32, device=dev)
    for r in range(R):
        W = prng.poisson1_weights_at(ed[:, r, None], sd[:, r, None], cols)
        acc = acc + W[..., None] * fd[:, r, None, :]
    part = torch.zeros((q, C, B, NUM_MOMENTS), dtype=torch.float32,
                       device=dev)
    part[uniq // C, uniq % C] = acc
    for c in range(C):
        out = out + part[:, c]
    return out


def sort_stream(gid: torch.Tensor, slot: torch.Tensor, x: torch.Tensor,
                mask: torch.Tensor, seed: torch.Tensor, m: int
                ) -> Tuple[torch.Tensor, ...]:
    """Permute an unsorted ``(gid, slot)`` stream into lane order, slots
    ascending within a lane (a stable sort: a permutation, no arithmetic).
    Elements whose ``gid`` lies outside ``[0, m)`` join lane 0 with mask 0.
    Returns ``(x, mask, slot, seed, lane_off (m + 1,), n_slots)``; reads the
    slot range on the host and raises on a negative slot."""
    gid = gid.to(torch.int64)
    slot = slot.to(torch.int64)
    in_range = (gid >= 0) & (gid < m)
    mask = torch.where(in_range, mask.to(torch.float32), 0.0)
    gid = torch.where(in_range, gid, 0)
    if slot.numel():
        lo, hi = torch.stack([slot.min(), slot.max()]).tolist()
        if lo < 0:
            raise ValueError("slots must be non-negative")
    else:
        hi = -1
    order = torch.sort(gid * (1 << 32) + slot, stable=True).indices
    lane_off = torch.searchsorted(
        gid[order], torch.arange(m + 1, device=gid.device))
    return (x[order], mask[order], slot[order], seed[order], lane_off,
            hi + 1)


def segment_bootstrap_moments_ref(gid: torch.Tensor, slot: torch.Tensor,
                                  x: torch.Tensor, mask: torch.Tensor,
                                  seed: torch.Tensor, m: int, B: int
                                  ) -> torch.Tensor:
    """(m, B, 3) per-lane replicate moment sums of an unsorted stream:
    row b of lane g is ``[sum w, sum w x, sum w x^2]`` over the elements of
    lane g with ``mask > 0``, weight ``poisson1(hash3(seed_j, slot_j,
    b))``."""
    xs, ms, ss, es, off, n_slots = sort_stream(gid, slot, x, mask, seed, m)
    return segment_bootstrap_sorted_ref(xs, ms, ss, es, off, B, n_slots)
