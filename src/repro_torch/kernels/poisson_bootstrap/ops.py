"""Wrapper of the Hopper Poisson-bootstrap kernel (``csrc/poisson_bootstrap.cu``).

``bootstrap_moments_masked`` is the fused loop's ESTIMATE entry: ``(..., B,
5)`` replicate moment sums of masked groups, with per-group counter seeds and
optional gating.  On a CUDA tensor it launches the kernel (or raises); on a
CPU tensor it runs the plain version (:mod:`.ref`), because no card is
there.  It never falls back.

The kernel is compiled with ``nvcc`` at first use into ``build/kernels/`` of
the checkout and bound through ``ctypes`` (:mod:`..nvcc`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import nvcc
from . import ref

_MAX_GRID_YZ = 65535


def _declare(lib: ctypes.CDLL) -> None:
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.pb_launch.argtypes = [P, LL, P, LL, P, P, P, P, I, I, I, P]
    lib.pb_launch.restype = I


_LIB = nvcc.Library("poisson_bootstrap.cu", _declare)
counter = nvcc.LaunchCounter()
build = _LIB.build
library = _LIB.load


def _rows(t: torch.Tensor, name: str, G: int, n: int):
    """(G, n) view with unit slot stride and one row stride, no copy."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if n > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name} needs a unit stride along its slot axis")
    try:
        v = t.view(G, n)
    except RuntimeError as err:
        raise ValueError(
            f"{name}'s leading dims must collapse to one row stride: {err}")
    return v, (v.stride(0) if G > 1 else n)


def _launch(x, mask, seeds, B, lane_active):
    if x.shape != mask.shape:
        raise ValueError(f"x {tuple(x.shape)} and mask {tuple(mask.shape)} differ")
    lead, n = tuple(x.shape[:-1]), x.shape[-1]
    G = 1
    for d in lead:
        G *= d
    dev = x.device
    for name, t in (("mask", mask), ("seeds", seeds)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if tuple(seeds.shape) != lead or seeds.dtype != torch.int64:
        raise ValueError(
            f"seeds must be int64 of shape {lead}, got {seeds.dtype} "
            f"{tuple(seeds.shape)}")
    if not 0 < B <= (1 << 24) or G > _MAX_GRID_YZ:
        raise ValueError(f"B={B} or {G} groups out of the kernel's range")
    if lane_active is None:
        act = torch.ones((G,), dtype=torch.int32, device=dev)
    else:
        if tuple(lane_active.shape) != lead or lane_active.device != dev:
            raise ValueError(f"lane_active must be {lead} on {dev}")
        act = lane_active.reshape(G).to(torch.int32).contiguous()
    out = torch.empty((G, B, ref.NUM_MOMENTS), dtype=torch.float32,
                      device=dev)
    if G == 0 or n == 0:
        return out.zero_().reshape(lead + (B, ref.NUM_MOMENTS))
    xv, x_row = _rows(x, "x", G, n)
    mv, m_row = _rows(mask, "mask", G, n)
    sv = seeds.reshape(G).contiguous()
    n_chunks = -(-n // ref.CHUNK)
    partial = torch.empty((G, n_chunks, ref.NUM_MOMENTS, B),
                          dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pb_launch(xv.data_ptr(), x_row, mv.data_ptr(), m_row,
                           sv.data_ptr(), act.data_ptr(), partial.data_ptr(),
                           out.data_ptr(), G, n, B, stream)
    if rc != 0:
        raise RuntimeError(f"poisson_bootstrap launch failed: CUDA error {rc}")
    counter.launches += 1
    return out.reshape(lead + (B, ref.NUM_MOMENTS))


def bootstrap_moments_masked(x: torch.Tensor, mask: torch.Tensor,
                             seeds: torch.Tensor, B: int, *,
                             lane_active: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """(..., B, 5) replicate moment sums of masked groups.

    Weight entry (j, b) of group g is ``poisson1(hash3(seeds[g], j, b))``
    with j the ABSOLUTE slot, so slicing the sample to a wider bucket with
    zero mask beyond the watermark changes nothing.  ``lane_active`` gates
    whole groups: inactive groups do no work and report zeros (callers pass
    it only when they discard those groups' outputs).  ``x``/``mask`` may be
    strided slices whose leading dims collapse to one row stride (the
    width-bucketed slice of the carried sample buffer).
    """
    if x.device.type == "cpu":
        return ref.bootstrap_moments_masked_ref(x, mask, seeds, B,
                                                lane_active=lane_active)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch(x, mask, seeds, B, lane_active)
