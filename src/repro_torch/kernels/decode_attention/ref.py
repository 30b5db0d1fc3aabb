"""Plain PyTorch version of the decode-attention kernel: dense single-query
GQA softmax in f32 over the first ``kv_len[b]`` cache positions of each row.

It computes what the reference's decode path evaluates: ``_sdpa`` of
``models/attention.py`` under the decode mask ``kj < kv_len[b]`` (the
Pallas kernel's oracle ``kernels/decode_attention/ref.py`` with a length per
row).  The CPU runs it; on the card only the comparisons call it.
"""
from __future__ import annotations

from typing import Union

import torch

NEG_INF = -1.0e30


def lengths(kv_len: Union[int, torch.Tensor], B: int, S: int,
            device) -> torch.Tensor:
    """``kv_len`` as a ``(B,)`` int32 tensor on ``device``, clamped to
    ``[0, S]``."""
    if not isinstance(kv_len, torch.Tensor):
        return torch.full((B,), min(max(int(kv_len), 0), S),
                          dtype=torch.int32, device=device)
    if kv_len.shape != (B,):
        raise ValueError(f"kv_len must be ({B},), got {tuple(kv_len.shape)}")
    return kv_len.to(device=device, dtype=torch.int32).clamp(0, S)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         kv_len: Union[int, torch.Tensor]) -> torch.Tensor:
    """q (B, Hq, d); k/v (B, S, Hkv, d), the cache's serving layout; query
    head ``h * G + g`` reads KV head ``h`` (G = Hq / Hkv); scores scaled by
    ``d**-0.5``.  Returns (B, Hq, d) in q's dtype: ``acc / max(l, 1e-30)``
    with ``l`` the softmax denominator over valid positions, so a row with
    ``kv_len == 0`` reads zeros, as the kernel writes them.  Positions past
    ``kv_len`` add exactly nothing, whatever they hold."""
    B, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    lens = lengths(kv_len, B, S, q.device)
    valid = torch.arange(S, device=q.device)[None, :] < lens[:, None]
    qg = q.float().reshape(B, Hkv, G, d)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * d ** -0.5
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * valid[:, None, None]
    vf = v.float().masked_fill(~valid[:, :, None, None], 0.0)
    acc = torch.einsum("bhgs,bshd->bhgd", p, vf)
    out = acc / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, Hq, d).to(q.dtype)
