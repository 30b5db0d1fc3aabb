"""Wrapper of the Hopper decode-attention kernel (``csrc/decode_attention.cu``).

``decode_attention(q, k, v, kv_len)`` is the decode step's attention: one
query token per row (q ``(B, Hq, d)``) over the first ``kv_len[b]``
positions of the cache in its serving layout (k/v ``(B, S_max, Hkv, d)``),
with ``kv_len`` an int or a ``(B,)`` device tensor that the kernel reads
itself -- no host read of the lengths.  On a CUDA tensor it launches the
kernel (or raises); on a CPU tensor it runs the plain version (:mod:`.ref`),
because no card is there.  It never falls back.

Unlike the reference's wrapper, it neither pads nor transposes the cache:
the kernel reads K and V rows through their strides, and only positions
below each row's length.
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from .. import nvcc, resolve_use_kernel
from . import ref

HEAD_DIMS = (32, 64, 128)
MAX_G = 16                  # query heads per KV head (kMaxG in the source)
CHUNK_QUANTUM = 64          # a split covers whole 64-position tiles
BLOCKS_PER_SM = 2           # splits aim at this many blocks per SM
_MAX_GRID_YZ = 65535


def _declare(lib: ctypes.CDLL) -> None:
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.da_launch.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I,
                              LL, LL, LL, LL, LL, LL, I, I, ctypes.c_float,
                              I, P]
    lib.da_launch.restype = I


_LIB = nvcc.Library("decode_attention.cu", _declare)
counter = nvcc.LaunchCounter()
build = _LIB.build
library = _LIB.load


def splits(B: int, Hkv: int, S: int, n_sm: int) -> tuple[int, int]:
    """``(n_split, chunk)``: the cache axis cut into ``n_split`` slices of
    ``chunk`` positions (a multiple of the 64-position tile) so that the
    grid holds about ``BLOCKS_PER_SM`` blocks per SM.  It depends on the
    cache's length and the grid, never on the lengths' values."""
    want = max(1, -(-BLOCKS_PER_SM * n_sm // (B * Hkv)))
    per = -(-S // want)
    chunk = -(-per // CHUNK_QUANTUM) * CHUNK_QUANTUM
    return -(-S // chunk), chunk


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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {q.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Union[int, torch.Tensor], *,
                     use_kernel: Union[bool, str] = "auto") -> torch.Tensor:
    """(B, Hq, d) attention of each row's query over its first ``kv_len[b]``
    cache positions, scores scaled by ``d**-0.5``, in q's dtype.
    ``use_kernel`` as :func:`..resolve_use_kernel`: ``True`` on a CPU tensor
    raises, and a CUDA tensor always takes the kernel."""
    _check(q, k, v)
    if not resolve_use_kernel(use_kernel, q.device):
        if q.device.type == "cuda":
            raise ValueError("a CUDA tensor takes the kernel; the plain "
                             "version is ref.decode_attention_ref")
        return ref.decode_attention_ref(q, k, v, kv_len)
    return _launch(q, k, v, kv_len)


def _launch(q, k, v, kv_len):
    B, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS or not 1 <= G <= MAX_G:
        raise ValueError(f"the kernel takes d in {HEAD_DIMS} and at most "
                         f"{MAX_G} query heads per KV head; got d={d}, G={G}")
    if S < 1 or B > _MAX_GRID_YZ or Hkv > _MAX_GRID_YZ:
        raise ValueError(f"cache shape {tuple(k.shape)} out of the kernel's "
                         f"range")
    item = q.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or any(s * item % 16 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a unit stride over d and 16-byte "
                             f"aligned rows; strides {t.stride()}")
    dev = q.device
    if isinstance(kv_len, torch.Tensor):       # the kernel clamps to [0, S]
        if kv_len.shape != (B,):
            raise ValueError(f"kv_len must be ({B},), got "
                             f"{tuple(kv_len.shape)}")
        lens = kv_len.to(device=dev, dtype=torch.int32).contiguous()
    else:
        lens = ref.lengths(kv_len, B, S, dev)
    q = q.contiguous()
    out = torch.empty_like(q)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, chunk = splits(B, Hkv, S, n_sm)
    parts = B * Hkv * n_split * G if n_split > 1 else 0
    m_part = torch.empty((parts,), dtype=torch.float32, device=dev)
    l_part = torch.empty((parts,), dtype=torch.float32, device=dev)
    acc_part = torch.empty((parts * d,), dtype=torch.float32, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.da_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           lens.data_ptr(), out.data_ptr(), m_part.data_ptr(),
                           l_part.data_ptr(), acc_part.data_ptr(), B, S, Hkv,
                           G, d, *k.stride()[:3], *v.stride()[:3], n_split,
                           chunk, d ** -0.5,
                           int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"decode attention launch failed: CUDA error {rc}")
    counter.launches += 1
    return out
