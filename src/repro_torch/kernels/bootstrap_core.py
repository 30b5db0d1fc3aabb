"""Host side of the device core shared by the two bootstrap kernels
(``csrc/bootstrap_core.cuh``): the replicate-tile shape and the scratch the
kernels keep between calls.

A replicate tile is 32 replicates a warp; ``ceil(B / 32)`` warps are split
into as few tiles of at most ``widest`` warps as still put about
:data:`UNITS_PER_SM` units of work (a chunk of a group and a tile) on every
SM.  The scratch -- chunk partials, their live flags and the groups' arrival
counters -- is allocated once per device and size class and kept, so a CUDA
graph that captured a call keeps valid pointers; the counters start at zero
and every call leaves them zero.  Calls on one device therefore run in
stream order, not concurrently on two streams.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

MAX_WARPS = 16              # boot::kMaxWarps
WARP = 32
UNITS_PER_SM = 2            # target units of work per SM
BLOCK_WARPS_PER_SM = 32     # a persistent grid holds about this many warps an SM

_sm_count: Dict[int, int] = {}
_scratch: Dict[tuple, torch.Tensor] = {}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_shape(B: int, units: int, n_sm: int,
               widest: int = MAX_WARPS) -> Tuple[int, int]:
    """``(warps, tiles)``: ``tiles`` replicate tiles of ``warps`` warps a
    block cover B replicates; the fewest tiles of at most ``widest`` warps
    (``MAX_WARPS`` where more than 65 535 tiles would be needed) for which
    ``units`` chunks times ``tiles`` reach ``UNITS_PER_SM * n_sm``, or one
    warp a tile."""
    bw = cdiv(B, WARP)
    tiles = cdiv(bw, widest)
    if tiles > 65535:
        tiles = cdiv(bw, MAX_WARPS)
    while True:
        warps = cdiv(bw, tiles)
        if warps == 1 or units * tiles >= UNITS_PER_SM * n_sm:
            return warps, tiles
        tiles = cdiv(bw, cdiv(warps, 2))


def sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    n = _sm_count.get(idx)
    if n is None:
        n = torch.cuda.get_device_properties(idx).multi_processor_count
        _sm_count[idx] = n
    return n


def scratch(dev: torch.device, tag: str, numel: int, dtype: torch.dtype,
            zero: bool = False) -> torch.Tensor:
    """A kept buffer of at least ``numel`` elements (a power-of-two size
    class), zeroed at allocation when ``zero``."""
    cap = 1 << max(10, (max(numel, 1) - 1).bit_length())
    key = (dev, tag, cap, dtype)
    buf = _scratch.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"the bootstrap kernels allocate their {tag} "
                               f"scratch on the first call of a size: make "
                               f"one call outside graph capture first")
        buf = (torch.zeros if zero else torch.empty)((cap,), dtype=dtype,
                                                     device=dev)
        _scratch[key] = buf
    return buf
