"""Wrapper of the Hopper decode-attention kernel (``csrc/decode_attention.cu``).

``decode_attention(q, k, v, kv_len, window=None)`` is the decode step's
attention: one query token per row (q ``(B, Hq, d)``) over the first
``kv_len[b]`` positions of the cache in its serving layout (k/v ``(B,
S_max, Hkv, d)``) -- under a sliding window of ``W`` positions over the
last ``W`` of them, ``[max(0, kv_len[b] - W), kv_len[b])`` -- with
``kv_len`` an int or a ``(B,)`` int32/int64 device tensor that the kernel
reads itself -- no host read of the lengths, no conversion.  With
``return_lse=True`` it also returns each query head's log-sum-exp of its
scores (``(B, Hq)`` f32, ``-1e30`` for an empty range), with which the
outputs of a cache split over positions merge (:func:`merge`).  On a CUDA
tensor it launches the kernel, one launch a call (or raises); on a CPU
tensor it runs the plain version (:mod:`.ref`), because no card is there,
and so it does on a meta tensor (a shapes-only trace computes no values).
It never falls back.

Unlike the reference's wrapper, it neither pads nor transposes the cache:
the kernel reads K and V rows through their strides, and only the
positions of each row's range.  The grid is fixed by the shapes and the card
(:func:`grid_blocks`); the kernel splits the ranges over it by the lengths
on the device (:func:`partition` is the same arithmetic).  The
splits' partials and the pairs' arrival counters are allocated once per
device and shape and kept, so a CUDA graph that captured them keeps valid
pointers; calls on one device therefore run in stream order, not
concurrently on two streams.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple, Union

import torch

from .. import nvcc, resolve_use_kernel
from . import ref

HEAD_DIMS = (32, 64, 120, 128)
MAX_G = 16                  # query heads per KV head (kMaxG in the source)
MAX_B = 1024                # rows (kMaxB: the lengths sit in shared memory)
BLOCKS_PER_SM = 2           # the grid holds about this many blocks per SM
_MAX_GRID = (1 << 31) - 1


def _declare(lib: ctypes.CDLL) -> None:
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.da_prepare.argtypes = []
    lib.da_prepare.restype = I
    lib.da_launch.argtypes = [P, P, P, P, I, I, I, P, P, P, P, I, I, I, I,
                              I, I, LL, LL, LL, LL, LL, LL, ctypes.c_float, I,
                              P]
    lib.da_launch.restype = I


_LIB = nvcc.Library("decode_attention.cu", _declare)
counter = nvcc.LaunchCounter()
build = _LIB.build
library = _LIB.load
_sm_count: Dict[int, int] = {}            # device index -> SMs (prepared)
_workspace: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def tile_rows(dtype: torch.dtype) -> int:
    """Positions of one K/V tile in shared memory: 64 in bf16, 32 in f32."""
    return 64 if dtype == torch.bfloat16 else 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def grid_blocks(B: int, Hkv: int, S: int, n_sm: int, tile: int = 64) -> int:
    """The kernel's grid: about ``BLOCKS_PER_SM`` blocks per SM, at least
    one per (row, KV head) pair and at most one per tile of the cache.  It
    depends on the shapes and the card, never on the lengths."""
    return max(B * Hkv, min(BLOCKS_PER_SM * n_sm, B * Hkv * _cdiv(S, tile)))


def row_range(length: int, S_max: int, window: Optional[int]
              ) -> Tuple[int, int]:
    """Row range ``(lo, hi)`` of one length: the kernel's arithmetic
    (``ref.bounds``)."""
    raw = max(int(length), 0)
    hi = min(raw, S_max)
    return (0 if window is None else min(max(raw - window, 0), hi)), hi


def partition(lengths, B: int, Hkv: int, S_max: int, n_sm: int,
              tile: int = 64, window: Optional[int] = None
              ) -> Tuple[int, int, List[Tuple[int, int, int, int]]]:
    """``(n_blocks, chunk, blocks)``: what every block of the kernel computes
    from the lengths.  Row b attends over ``[lo_b, hi_b)``
    (:func:`row_range`).  ``chunk`` is the smallest whole number of tiles
    for which the splits of every (row, KV head) pair -- ``ceil((hi - lo)
    / chunk)``, or one for an empty range -- fit the ``n_blocks`` of the
    grid.  ``blocks[i] = (b, h, lo, hi)`` is block i's slice of row b's
    positions for KV head h, rows in order, then heads, then splits; split
    s covers ``[lo_b + s * chunk, min(lo_b + (s + 1) * chunk, hi_b))``;
    blocks past ``len(blocks)`` exit at once.  A pair with an empty range
    has one block with ``lo == hi``, which writes zeros."""
    if len(lengths) != B:
        raise ValueError(f"need {B} lengths, got {len(lengths)}")
    ranges = [row_range(x, S_max, window) for x in lengths]
    lens = [hi - lo for lo, hi in ranges]
    n_blocks = grid_blocks(B, Hkv, S_max, n_sm, tile)

    def fits(t: int) -> bool:
        splits = sum(max(1, _cdiv(L, t * tile)) for L in lens)
        return Hkv * splits <= n_blocks

    lo, hi = 1, _cdiv(S_max, tile)       # one split a pair always fits
    while lo < hi:                       # the count falls as chunks grow
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if fits(mid) else (mid + 1, hi)
    chunk = lo * tile
    blocks = []
    for b, ((lo_b, hi_b), L) in enumerate(zip(ranges, lens)):
        ns = max(1, _cdiv(L, chunk))
        for h in range(Hkv):
            blocks += [(b, h, lo_b + min(s * chunk, L),
                        lo_b + min(s * chunk + chunk, L)) for s in range(ns)]
    return n_blocks, chunk, blocks


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Hq, d), k/v (B, S, Hkv, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, d = q.shape
    if k.shape[0] != B or k.shape[3] != d or Hq % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q "
                             f"{q.dtype} on {q.device}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"no kernel for device {q.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Union[int, torch.Tensor], *,
                     window: Optional[int] = None,
                     use_kernel: Union[bool, str] = "auto",
                     return_lse: bool = False):
    """(B, Hq, d) attention of each row's query over its first ``kv_len[b]``
    cache positions (the last ``window`` of them under a sliding window),
    scores scaled by ``d**-0.5``, in q's dtype; with ``return_lse`` the pair
    (out, lse).  ``use_kernel`` as :func:`..resolve_use_kernel`: ``True`` on
    a CPU tensor raises, and a CUDA tensor always takes the kernel."""
    _check(q, k, v)
    if window is not None and (int(window) != window or window < 1):
        raise ValueError(f"window must be a positive int, got {window!r}")
    if not resolve_use_kernel(use_kernel, q.device):
        if q.device.type == "cuda":
            raise ValueError("a CUDA tensor takes the kernel; the plain "
                             "version is ref.decode_attention_ref")
        return ref.decode_attention_ref(q, k, v, kv_len, window,
                                        return_lse=return_lse)
    return _launch(q, k, v, kv_len, window, return_lse)


def merge(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The attention over a cache split into ``n`` parts over positions,
    from each part's ``(out, lse)``: ``outs`` ``(n, ..., d)``, ``lses``
    ``(n, ...)`` stacked over the parts.  Each part weighs ``exp(lse -
    max lse)``; parts with an empty range (lse ``-1e30``) weigh nothing
    unless every part is empty, and then the zeros average to zeros.  f32."""
    top = lses.amax(dim=0, keepdim=True)
    w = torch.exp(lses - top)
    return (w[..., None] * outs.float()).sum(0) / w.sum(0)[..., None]


def _prepared(dev: torch.device, lib: ctypes.CDLL) -> int:
    """The device's SM count; the first call on a device also raises the
    kernels' shared-memory limit there."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    n_sm = _sm_count.get(idx)
    if n_sm is None:
        with torch.cuda.device(idx):
            rc = lib.da_prepare()
        if rc != 0:
            raise RuntimeError(f"decode attention setup failed: CUDA error "
                               f"{rc}")
        n_sm = torch.cuda.get_device_properties(idx).multi_processor_count
        _sm_count[idx] = n_sm
    return n_sm


def _buffers(dev: torch.device, B: int, Hkv: int, n_blocks: int, G: int,
             d: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The splits' partials and the pairs' arrival counters (zeros, which
    every call leaves zero), kept for the life of the process."""
    key = (dev, B, Hkv, n_blocks, G, d)
    bufs = _workspace.get(key)
    if bufs is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode attention allocates its workspace on "
                               "its first call for a shape: make one call "
                               "outside graph capture first")
        bufs = (torch.empty((n_blocks * G * (d + 2),), dtype=torch.float32,
                            device=dev),
                torch.zeros((B * Hkv,), dtype=torch.int32, device=dev))
        _workspace[key] = bufs
    return bufs


def _launch(q, k, v, kv_len, window, return_lse=False):
    B, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS or not 1 <= G <= MAX_G:
        raise ValueError(f"the kernel takes d in {HEAD_DIMS} and at most "
                         f"{MAX_G} query heads per KV head; got d={d}, G={G}")
    tile = tile_rows(q.dtype)
    if not 1 <= B <= MAX_B or S < 1 or B * Hkv * _cdiv(S, tile) > _MAX_GRID:
        raise ValueError(f"cache shape {tuple(k.shape)} out of the kernel's "
                         f"range (at most {MAX_B} rows)")
    item = q.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s * item % 16 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a unit stride over d and 16-byte "
                             f"aligned rows; strides {t.stride()}")
    dev = q.device
    if isinstance(kv_len, torch.Tensor):       # the kernel clamps the range
        if kv_len.shape != (B,):
            raise ValueError(f"kv_len must be ({B},), got "
                             f"{tuple(kv_len.shape)}")
        if kv_len.device != dev or kv_len.dtype not in (torch.int32,
                                                        torch.int64):
            kv_len = kv_len.to(device=dev, dtype=torch.int32)
        lens = kv_len.contiguous()
        lens_ptr, kind, fixed = lens.data_ptr(), 1 + (
            lens.dtype == torch.int64), 0
    else:
        lens_ptr, kind, fixed = None, 0, min(max(int(kv_len), 0), _MAX_GRID)
    q = q.contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty(q.shape[:2], dtype=torch.float32, device=dev)
           if return_lse else None)
    lib = library()
    n_sm = _prepared(dev, lib)
    n_blocks = grid_blocks(B, Hkv, S, n_sm, tile)
    part, arrivals = _buffers(dev, B, Hkv, n_blocks, G, d)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.da_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           lens_ptr, kind, fixed,
                           min(int(window or 0), _MAX_GRID), out.data_ptr(),
                           None if lse is None else lse.data_ptr(),
                           part.data_ptr(), arrivals.data_ptr(), n_blocks, B,
                           S, Hkv, G, d, *k.stride()[:3], *v.stride()[:3],
                           d ** -0.5, int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"decode attention launch failed: CUDA error {rc}")
    counter.launches += 1
    return (out, lse) if return_lse else out
