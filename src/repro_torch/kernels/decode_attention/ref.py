"""Plain PyTorch version of the decode-attention kernel: dense single-query
GQA softmax in f32 over positions ``[lo[b], hi[b])`` of each row's cache:
the first ``kv_len[b]`` positions, or under a sliding window of ``W``
positions the last ``W`` of them.

It computes what the reference's decode path evaluates: ``_sdpa`` of
``models/attention.py`` under the decode mask ``kj < kv_len[b]`` (and ``kj
>= kv_len[b] - W`` under a window; the Pallas kernel's oracle
``kernels/decode_attention/ref.py`` with a length per row).  The CPU runs
it; on the card only the comparisons call it.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

NEG_INF = -1.0e30


def bounds(kv_len: Union[int, torch.Tensor], B: int, S: int,
           window: Optional[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's range ``(lo, hi)`` as ``(B,)`` int64 tensors on
    ``device``: ``hi = min(max(kv_len, 0), S)`` and, under a window, ``lo =
    min(max(kv_len - window, 0), hi)``, else 0 (the kernel's arithmetic)."""
    if isinstance(kv_len, torch.Tensor):
        if kv_len.shape != (B,):
            raise ValueError(f"kv_len must be ({B},), got "
                             f"{tuple(kv_len.shape)}")
        raw = kv_len.to(device=device, dtype=torch.int64).clamp(min=0)
    else:
        raw = torch.full((B,), max(int(kv_len), 0), dtype=torch.int64,
                         device=device)
    hi = raw.clamp(max=S)
    if window is None:
        return torch.zeros_like(hi), hi
    return torch.minimum((raw - window).clamp(min=0), hi), hi


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: Union[int, torch.Tensor],
                         window: Optional[int] = None) -> torch.Tensor:
    """q (B, Hq, d); k/v (B, S, Hkv, d), the cache's serving layout; query
    head ``h * G + g`` reads KV head ``h`` (G = Hq / Hkv); scores scaled by
    ``d**-0.5``.  Returns (B, Hq, d) in q's dtype: ``acc / max(l, 1e-30)``
    with ``l`` the softmax denominator over the row's range (:func:`bounds`),
    so an empty range reads zeros, as the kernel writes them.  Positions
    outside the range add exactly nothing, whatever they hold."""
    B, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    lo, hi = bounds(kv_len, B, S, window, q.device)
    pos = torch.arange(S, device=q.device)[None, :]
    valid = (pos < hi[:, None]) & (pos >= lo[:, None])
    qg = q.float().reshape(B, Hkv, G, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * d ** -0.5
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid[:, None, None]
    vf = v.float().masked_fill(~valid[:, :, None, None], 0.0)
    acc = torch.einsum("bhgs,bshd->bhgd", p, vf)
    out = acc / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, Hq, d).to(q.dtype)
