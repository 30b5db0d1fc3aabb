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
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from .. import nvcc
from . import ref

_MAX_LANES = 65535
_MAX_B = 1 << 22
_MAX_AGG_GROUPS = 12 * 65535     # kGroupTile groups per grid row


def _declare(lib: ctypes.CDLL) -> None:
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.seg_boot_launch.argtypes = [P, P, P, P, P, P, P, I, I, I, P]
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


def _launch_boot(x, mask, slot, seed, lane_off, B, n_slots):
    dev = x.device
    L = x.shape[0]
    q = lane_off.shape[0] - 1
    if not 0 < B <= _MAX_B or not 0 <= q <= _MAX_LANES:
        raise ValueError(f"B={B} or {q} lanes out of the kernel's range")
    x = _flat(x, "x", L, torch.float32)
    mask = _flat(mask, "mask", L, torch.float32)
    slot = _flat(slot, "slot", L, torch.int32)
    seed = _flat(seed, "seed", L, torch.int64)
    off = _flat(lane_off, "lane_off", q + 1, torch.int64)
    out = torch.empty((q, B, ref.NUM_MOMENTS), dtype=torch.float32,
                      device=dev)
    n_chunks = -(-int(n_slots) // ref.CHUNK)
    if L == 0 or q == 0 or n_chunks == 0:
        return out.zero_()
    partial = torch.empty((q, n_chunks, ref.NUM_MOMENTS, B),
                          dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.seg_boot_launch(x.data_ptr(), mask.data_ptr(),
                                 slot.data_ptr(), seed.data_ptr(),
                                 off.data_ptr(), partial.data_ptr(),
                                 out.data_ptr(), q, B, n_chunks, stream)
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
    in ``[0, n_slots)``; row b of lane g is ``[sum w, sum w x, sum w x^2]``
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
