"""Wrappers of the Hopper segment kernels (``csrc/segment_agg.cu``).

* :func:`segment_bootstrap_sorted` -- the grouped block's ESTIMATE entry:
  ``(q, B, 3)`` replicate moment sums over a packed stream sorted by lane
  (slot-ascending within a lane), given the lane offsets.
* :func:`segment_bootstrap_moments` -- the same function on an unsorted
  ``(gid, slot)`` stream (the reference op's signature): a stable sort by
  (lane, slot) first, a permutation only.
* :func:`segment_aggregate` -- exact GROUP BY count/sum/sumsq/sum3/sum4/
  min/max for any group count in one launch.

On a CUDA tensor each launches its kernel (or raises); on a CPU tensor it
runs the plain version (:mod:`.ref`), because no card is there.  None falls
back.  Each kernel counts its launches.

The segment bootstrap gives a block only to the (lane, 256-slot chunk)
items inside the lanes' spans; :func:`seg_grid` is its grid (host values
only, so a CUDA graph can hold a call) and :func:`seg_plan` the items every
block lays out from the lane offsets, the same arithmetic as the kernel's.
Its scratch is kept between calls (:mod:`..bootstrap_core`), so calls on
one device run in stream order.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import bootstrap_core as core
from .. import nvcc
from . import ref

_MAX_LANES = 65535
_MAX_B = 1 << 22
_MAX_AGG_GROUPS = 12 * 65535     # kGroupTile groups per grid row
PLAN_LANES = 512                 # lanes a block plans in shared memory


def _declare(lib: ctypes.CDLL) -> None:
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.seg_boot_launch.argtypes = [P, P, P, P, P, P, P, P, P, P, I, I,
                                    I, I, I, I, P]
    lib.seg_boot_launch.restype = I
    lib.seg_agg_launch.argtypes = [P, P, P, LL, I, P, P, P]
    lib.seg_agg_launch.restype = I


_LIB = nvcc.Library("segment_agg.cu", _declare)
boot_counter = nvcc.LaunchCounter()
agg_counter = nvcc.LaunchCounter()
build = _LIB.build
library = _LIB.load


def _device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    return dev


def _flat(t: torch.Tensor, name: str, n: int, dtype) -> torch.Tensor:
    if t.dim() != 1 or t.shape[0] != n:
        raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
    return t.to(dtype).contiguous()


def seg_grid(L: int, q: int, n_slots: int, B: int,
             n_sm: int) -> Tuple[int, int, int]:
    """``(blocks, warps, tiles)`` of the segment bootstrap: ``tiles``
    replicate tiles of ``warps`` warps (:func:`..bootstrap_core.tile_shape`)
    over an estimate of the items, ``L / 256 + 2q`` (a bound where the lanes'
    slots are contiguous), and a persistent grid of at most about
    ``BLOCK_WARPS_PER_SM`` warps an SM that strides over the units.  It
    depends on these host values only, never on the data."""
    n_chunks = max(1, core.cdiv(n_slots, ref.CHUNK))
    items = max(1, min(q * n_chunks, core.cdiv(L, ref.CHUNK) + 2 * q))
    warps, tiles = core.tile_shape(B, items, n_sm)
    cap = n_sm * max(1, core.BLOCK_WARPS_PER_SM // warps)
    return max(1, min(items * tiles, cap)), warps, tiles


def seg_plan(lane_off: Sequence[int], slot: Sequence[int],
             n_slots: int) -> Tuple[List[int], List[Tuple[int, int, int,
                                                          int]]]:
    """``(base, items)``: the items the kernel's blocks lay out, in order.
    Item ``i = base[g] + k`` is lane g's k-th chunk ``c`` from the chunk of
    its first slot to that of its last (clamped to ``[0, ceil(n_slots /
    256))``), ``items[i] = (g, c, lo, hi)`` its elements ``[lo, hi)``.  A
    lane whose last and first slots differ by its count less one takes the
    range by arithmetic, kept where the four boundary slots confirm it; any
    other range is a search (``searchsorted``)."""
    off = [int(v) for v in lane_off]
    sl = np.asarray(slot, dtype=np.int64)
    q = len(off) - 1
    nc = max(1, core.cdiv(n_slots, ref.CHUNK))

    def chunk(s: int) -> int:
        return min(max(s >> 8, 0), nc - 1)

    spans, base = [], [0]
    for g in range(q):
        a, e = off[g], off[g + 1]
        span = (chunk(int(sl[a])), chunk(int(sl[e - 1]))) if a < e else (0, -1)
        spans.append(span)
        base.append(base[-1] + max(0, span[1] - span[0] + 1))
    items = []
    for g in range(q):
        a, e = off[g], off[g + 1]
        for c in range(spans[g][0], spans[g][0] + base[g + 1] - base[g]):
            c_lo, c_hi = c * ref.CHUNK, (c + 1) * ref.CHUNK
            s0, s1 = int(sl[a]), int(sl[e - 1])
            ok = False
            if s1 - s0 == e - a - 1:
                lo = a + max(c_lo, s0) - s0
                hi = a + min(c_hi, s1 + 1) - s0
                ok = ((lo == a or sl[lo - 1] < c_lo) and sl[lo] >= c_lo
                      and sl[hi - 1] < c_hi and (hi == e or sl[hi] >= c_hi))
            if not ok:
                lo = a + int(np.searchsorted(sl[a:e], c_lo))
                hi = a + int(np.searchsorted(sl[a:e], c_hi))
            items.append((g, c, lo, hi))
    return base, items


def _launch_boot(x, mask, slot, seed, lane_off, B, n_slots):
    dev = x.device
    L = x.shape[0]
    q = lane_off.shape[0] - 1
    if not 0 < B <= _MAX_B or not 0 <= q <= _MAX_LANES or L >= 1 << 31:
        raise ValueError(f"B={B}, {q} lanes or L={L} out of the kernel's "
                         f"range")
    x = _flat(x, "x", L, torch.float32)
    mask = _flat(mask, "mask", L, torch.float32)
    slot = _flat(slot, "slot", L, torch.int32)
    seed = _flat(seed, "seed", L, torch.int64)
    off = _flat(lane_off, "lane_off", q + 1, torch.int64)
    out = torch.empty((q, B, ref.NUM_MOMENTS), dtype=torch.float32,
                      device=dev)
    n_chunks = core.cdiv(int(n_slots), ref.CHUNK)
    if L == 0 or q == 0 or n_chunks <= 0:
        return out.zero_()
    blocks, warps, tiles = seg_grid(L, q, int(n_slots), B, core.sm_count(dev))
    units = q * n_chunks * tiles                 # at most: every chunk a lane
    part = core.scratch(dev, "seg_part", units * ref.NUM_MOMENTS * warps
                        * core.WARP, torch.float32)
    flag = core.scratch(dev, "seg_flag", units, torch.int32)
    count = core.scratch(dev, "seg_count", q * tiles, torch.int32, zero=True)
    plan = (core.scratch(dev, "seg_plan", 4 * q + 2, torch.int32)
            if q > PLAN_LANES else None)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.seg_boot_launch(x.data_ptr(), mask.data_ptr(),
                                 slot.data_ptr(), seed.data_ptr(),
                                 off.data_ptr(),
                                 None if plan is None else plan.data_ptr(),
                                 part.data_ptr(), flag.data_ptr(),
                                 count.data_ptr(), out.data_ptr(), q, B,
                                 n_chunks, blocks, warps, tiles, stream)
    if rc != 0:
        raise RuntimeError(f"segment bootstrap launch failed: CUDA error {rc}")
    boot_counter.launches += 1
    return out


def segment_bootstrap_sorted(x: torch.Tensor, mask: torch.Tensor,
                             slot: torch.Tensor, seed: torch.Tensor,
                             lane_off: torch.Tensor, B: int,
                             n_slots: int) -> torch.Tensor:
    """(q, B, 3) replicate moment sums of a packed stream sorted by lane and
    by slot within a lane.

    Lane g owns elements ``[lane_off[g], lane_off[g + 1])``; every slot lies
    in ``[0, n_slots)``, ascending within a lane (sparse or repeated slots
    too); row b of lane g is ``[sum w, sum w x, sum w x^2]``
    over its elements with ``mask > 0``, weight ``poisson1(hash3(seed_j,
    slot_j, b))`` -- the draw the Poisson-bootstrap kernel makes for that
    (seed, slot, replicate).  A lane that owns no element reads zeros.
    """
    dev = _device(x, mask, slot, seed, lane_off)
    if dev.type == "cpu":
        return ref.segment_bootstrap_sorted_ref(x, mask, slot, seed,
                                                lane_off, B, n_slots)
    return _launch_boot(x, mask, slot, seed, lane_off, B, n_slots)


def segment_bootstrap_moments(gid: torch.Tensor, slot: torch.Tensor,
                              x: torch.Tensor, mask: torch.Tensor,
                              seed: torch.Tensor, m: int,
                              B: int) -> torch.Tensor:
    """(m, B, 3) per-lane replicate moment sums of an unsorted stream (the
    reference op): ``gid`` the owning lane (outside ``[0, m)``: no lane),
    ``slot`` the non-negative absolute slot, ``seed`` the per-element
    uint32 seed pattern.  Sorts by (lane, slot), then
    :func:`segment_bootstrap_sorted`; reads the slot range on the host."""
    _device(gid, slot, x, mask, seed)
    xs, ms, ss, es, off, n_slots = ref.sort_stream(gid, slot, x, mask, seed,
                                                   m)
    return segment_bootstrap_sorted(xs, ms, ss, es, off, B, n_slots)


def segment_aggregate(gid: torch.Tensor, x: torch.Tensor, mask: torch.Tensor,
                      m: int) -> Dict[str, torch.Tensor]:
    """Per-group count/sum/sumsq/sum3/sum4/min/max ``(m,)`` of a stream in
    any order: sums weight the powers of ``x`` by ``mask``, min/max range
    over ``mask > 0``, ``gid`` outside ``[0, m)`` belongs to no group, and
    an empty group reads min ``3e38``, max ``-3e38``."""
    dev = _device(gid, x, mask)
    if dev.type == "cpu":
        return ref.segment_aggregate_ref(gid, x, mask, m)
    n = x.shape[0]
    gid = _flat(gid, "gid", n, torch.int32)
    x = _flat(x, "x", n, torch.float32)
    mask = _flat(mask, "mask", n, torch.float32)
    if not 0 < m <= _MAX_AGG_GROUPS:
        raise ValueError(f"m={m} out of the kernel's range")
    nb = max(1, -(-n // ref.AGG_TILE))
    tiles = torch.empty((nb, m, 7), dtype=torch.float32, device=dev)
    out = torch.empty((7, m), dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.seg_agg_launch(gid.data_ptr(), x.data_ptr(), mask.data_ptr(),
                                n, m, tiles.data_ptr(), out.data_ptr(),
                                stream)
    if rc != 0:
        raise RuntimeError(f"segment aggregate launch failed: CUDA error {rc}")
    agg_counter.launches += 1
    res = {k: out[i] for i, k in enumerate(ref.AGG_KEYS)}
    res["min"], res["max"] = out[5], out[6]
    return res
