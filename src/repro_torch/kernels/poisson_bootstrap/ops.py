"""Wrappers of the Hopper Poisson-bootstrap kernel (``csrc/poisson_bootstrap.cu``).

* ``bootstrap_moments_masked`` -- the fused loop's ESTIMATE entry: ``(...,
  B, 5)`` replicate moment sums of masked groups, with per-group counter
  seeds and optional gating;
* ``bootstrap_moments`` -- the same for one group (G = 1): ``(B, 5)``;
* ``estimate_error_moments`` -- the host route's ESTIMATE for the moment
  estimators (the reference's moments entry): per-group seeds from
  ``randint(key, (m,), 0, 2**31 - 1)``, one kernel launch over the m
  groups, the dead-replicate guard, the finish and the (1 - delta)
  quantile of the joint metric.

On a CUDA tensor each launches the kernel (or raises); on a CPU tensor it
runs the plain version (:mod:`.ref`), because no card is there.  None falls
back.

The kernel is compiled with ``nvcc`` at first use into ``build/kernels/`` of
the checkout and bound through ``ctypes`` (:mod:`..nvcc`).  A call is one
kernel launch; its scratch is kept between calls (:mod:`..bootstrap_core`),
so calls on one device run in stream order.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import bootstrap_core as core
from .. import nvcc
from . import ref

_MAX_GRID_YZ = 65535
TILE_WARPS = 8      # replicate warps a block at most (B = 300: two of five)


def _declare(lib: ctypes.CDLL) -> None:
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.pb_launch.argtypes = [P, LL, P, LL, P, P, I, I, LL, LL, P, P, P, P,
                              I, I, I, I, I, P]
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


def _gate(lane_active: Optional[torch.Tensor], lead: tuple, G: int, dev):
    """``(tensor, kind, inner, s_outer, s_inner)``: the kernel reads group
    g's flag at ``(g // inner) * s_outer + (g % inner) * s_inner`` as bool
    (kind 1) or int32 (kind 2) -- a broadcast (expanded) gate is read in
    place, without a conversion; other dtypes are converted to int32.  No
    gate is kind 0."""
    if lane_active is None:
        return None, 0, 1, 0, 0
    if tuple(lane_active.shape) != lead or lane_active.device != dev:
        raise ValueError(f"lane_active must be {lead} on {dev}")
    a = lane_active
    if a.dtype not in (torch.bool, torch.int32):
        a = a.to(torch.int32)
    if a.dim() > 2:
        a = a.reshape(G)
    kind = 1 if a.dtype == torch.bool else 2
    if a.dim() == 0:
        return a, kind, 1, 0, 0
    if a.dim() == 1:
        return a, kind, G, 0, a.stride(0)
    return a, kind, a.shape[1], a.stride(0), a.stride(1)


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
    act, kind, inner, s0, s1 = _gate(lane_active, lead, G, dev)
    out = torch.empty((G, B, ref.NUM_MOMENTS), dtype=torch.float32,
                      device=dev)
    if G == 0 or n == 0:
        return out.zero_().reshape(lead + (B, ref.NUM_MOMENTS))
    xv, x_row = _rows(x, "x", G, n)
    mv, m_row = _rows(mask, "mask", G, n)
    sv = seeds.reshape(G).contiguous()
    n_chunks = core.cdiv(n, ref.CHUNK)
    warps, tiles = core.tile_shape(B, G * n_chunks, core.sm_count(dev),
                                   TILE_WARPS)
    units = G * n_chunks * tiles
    part = core.scratch(dev, "pb_part", units * ref.NUM_MOMENTS * warps
                        * core.WARP, torch.float32)
    flag = core.scratch(dev, "pb_flag", units, torch.int32)
    count = core.scratch(dev, "pb_count", G * tiles, torch.int32, zero=True)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.pb_launch(xv.data_ptr(), x_row, mv.data_ptr(), m_row,
                           sv.data_ptr(),
                           None if act is None else act.data_ptr(), kind,
                           inner, s0, s1, part.data_ptr(), flag.data_ptr(),
                           count.data_ptr(), out.data_ptr(), G, n, B, warps,
                           tiles, stream)
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
    it only when they discard those groups' outputs); on the card a bool or
    int32 gate, expanded or not, is read in place.  ``x``/``mask`` may be
    strided slices whose leading dims collapse to one row stride (the
    width-bucketed slice of the carried sample buffer).
    """
    if x.device.type == "cpu":
        return ref.bootstrap_moments_masked_ref(x, mask, seeds, B,
                                                lane_active=lane_active)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return _launch(x, mask, seeds, B, lane_active)


def bootstrap_moments(x: torch.Tensor, mask: torch.Tensor, seed: int,
                      B: int) -> torch.Tensor:
    """(B, 5) replicate moment sums of one masked group under the uint32
    counter seed ``seed``."""
    seeds = torch.full((1,), int(seed) & 0xFFFFFFFF, dtype=torch.int64,
                       device=x.device)
    return bootstrap_moments_masked(x[None], mask[None], seeds, B)[0]


def estimate_error_moments(est_name: str, sample: torch.Tensor,
                           mask: torch.Tensor, scale: torch.Tensor, key,
                           delta: float, B: int = 500, metric: str = "l2",
                           active: Optional[torch.Tensor] = None):
    """Kernel-backed ESTIMATE with ``core.bootstrap.estimate_error``'s
    contract, ``(e, theta_hat (m, 1))``, for a moment estimator on ``sample
    (m, n_cap, c)`` / ``mask (m, n_cap)``.

    ``active (m,)`` gates groups in the kernel: an inactive group does no
    work and contributes zero error (its theta falls back to the plain
    sample through the dead-replicate guard); pass it only when the caller
    discards those groups' contributions.
    """
    from ...core import keys as keylib
    from ...core.bootstrap import finish_lanes_moments
    from ...core.estimators import get as get_estimator
    from ...core.reduce import tree_sum

    est = get_estimator(est_name)
    if est.moments_finish is None:
        raise ValueError(f"{est_name} is not a moment estimator")
    dev = sample.device
    m = sample.shape[0]
    seeds = torch.as_tensor(
        keylib.randint(key, (m,), 0, 2 ** 31 - 1).astype(np.int64),
        device=dev)
    v = sample[..., 0].to(torch.float32).contiguous()
    mf = mask.to(torch.float32)
    M = bootstrap_moments_masked(v, mf, seeds, B, lane_active=active)
    feats = torch.stack([mf, mf * v, mf * v * v], dim=-1)      # (m, n, 3)
    M_plain = tree_sum(feats, 1)                          # (m, 3)
    deltas = torch.full((1,), float(delta), dtype=torch.float32, device=dev)
    e, theta = finish_lanes_moments(
        M[None, ..., :3], M_plain[None], scale[None].to(torch.float32),
        deltas, est=est, metric=metric)
    return e[0], theta[0]
