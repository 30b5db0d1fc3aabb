"""Wrapper of the Hopper Poisson-bootstrap kernel (``csrc/poisson_bootstrap.cu``).

``bootstrap_moments_masked`` is the fused loop's ESTIMATE entry: ``(..., B,
5)`` replicate moment sums of masked groups, with per-group counter seeds and
optional gating.  On a CUDA tensor it launches the kernel (or raises); on a
CPU tensor it runs the plain version (:mod:`.ref`), because no card is
there.  It never falls back.

The kernel is compiled with ``nvcc`` at first use into ``build/kernels/`` of
the checkout and bound through ``ctypes``: a plain C entry point, pointers
from ``data_ptr()``, PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

from . import ref

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "poisson_bootstrap.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_MAX_GRID_YZ = 65535


class LaunchCounter:
    """Number of times the wrapper launched the kernel (not the plain
    version); a run resets it and reads it back to show it went through
    the kernel."""

    def __init__(self):
        self.launches = 0

    def reset(self) -> None:
        self.launches = 0


counter = LaunchCounter()
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernel cannot be built")
    return path


def library_path() -> Path:
    """Where the built library lands: keyed by the source and the flags, so
    an edited source is rebuilt and a stale library is never loaded."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpoisson_bootstrap_{digest.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernel unless it is already built; returns the library.
    ``verbose`` adds ``-Xptxas -v`` and prints the compiler's report."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.pb_launch.argtypes = [P, LL, P, LL, P, P, P, P, I, I, I, P]
            lib.pb_launch.restype = I
            _lib = lib
    return _lib


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
