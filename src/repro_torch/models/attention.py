"""GQA self-attention (full or sliding-window, optional per-head QK norm)
in train/prefill and decode modes, with preallocated KV caches for serving.

Prefill and teacher forcing run plain f32 einsums (the reference's
``_sdpa``, which no Pallas kernel covers) under the causal mask, windowed
when the config sets ``sliding_window``.  Decode goes through the
decode-attention op (``kernels/decode_attention``): the CUDA kernel on the
card, its plain version on the CPU, one launch per layer and step.  The
reference's decode evaluates ``_sdpa`` under the mask ``kj <= length[b]``
(and ``kj > length[b] - W`` under a window of W); the op computes the same
function with ``kv_len[b] = length[b] + 1``, over ``[max(0, kv_len[b] - W),
min(kv_len[b], S_max))``.  An idle slot whose window has moved wholly past
the cache (``length >= S_max + W - 1``) reads zeros where the reference
averages every position; no request reads it.

QK norm (the Qwen3 signature) is an RMS norm of each head's q and k, in
f32, before RoPE.  Unlike the reference, which returns a new cache, decode
writes the new K/V row into the cache tensors in place (the returned cache
shares them) and returns a new length tensor.

Cross-attention (the encoder-decoder's decoder, the vision model's image
layers) attends over a fixed memory whose K/V are projected once
(:func:`cross_kv`, no RoPE).  Prefill and teacher forcing run ``_sdpa``
over the whole memory, as the reference does; a decode step (one query a
row) goes through the decode-attention op at ``kv_len = T``, an int, so
the kernel reads no lengths.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..kernels.decode_attention import ops as da_ops
from . import nn
from .config import ModelConfig

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S_max, Hkv, dh)
    v: torch.Tensor          # (B, S_max, Hkv, dh)
    length: torch.Tensor     # (B,) int32 per-sequence fill (continuous batching)


def init_attn(generator: torch.Generator, cfg: ModelConfig, dtype, device,
              *, cross: bool = False):
    """Projections (and the config's QKV biases and QK norm gains); a cross
    projection takes no bias."""
    dh, H, Hkv, d = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    p = {
        "wq": nn.dense_init(generator, d, H * dh, dtype, device),
        "wk": nn.dense_init(generator, d, Hkv * dh, dtype, device),
        "wv": nn.dense_init(generator, d, Hkv * dh, dtype, device),
        "wo": nn.dense_init(generator, H * dh, d, dtype, device,
                            scale=(H * dh) ** -0.5),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((H * dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((Hkv * dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((Hkv * dh,), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = nn.rms_norm_init(dh, device)
        p["k_norm"] = nn.rms_norm_init(dh, device)
    return p


def _project_q(p, cfg: ModelConfig, x, rope):
    """(B, S, H, dh) queries; ``rope`` the (cos, sin) of the positions,
    computed once per call for both projections, or None (no RoPE)."""
    B, S, _ = x.shape
    q = nn.dense(p["wq"], x, p.get("bq")).reshape(B, S, cfg.n_heads,
                                                  cfg.head_dim)
    if cfg.qk_norm:
        q = nn.rms_norm(p["q_norm"], q, cfg.rms_eps)
    return q if rope is None else nn.apply_rope(q, *rope)


def _project_kv(p, cfg: ModelConfig, x, rope):
    B, S, _ = x.shape
    dh, Hkv = cfg.head_dim, cfg.n_kv_heads
    k = nn.dense(p["wk"], x, p.get("bk")).reshape(B, S, Hkv, dh)
    v = nn.dense(p["wv"], x, p.get("bv")).reshape(B, S, Hkv, dh)
    if cfg.qk_norm:
        k = nn.rms_norm(p["k_norm"], k, cfg.rms_eps)
    return (k if rope is None else nn.apply_rope(k, *rope)), v


def _sdpa(q, k, v, mask):
    """q (B,S,H,dh), k/v (B,T,Hkv,dh), mask (S,T) bool or None (every key,
    the reference's all-ones mask: the same values); f32."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(),
                          k.float()) * (dh ** -0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, dh).to(q.dtype)


def causal_mask(S: int, T: int, window: Optional[int] = None, device=None):
    """(S, T) bool; query i attends keys j <= i (and j > i - window under a
    sliding window)."""
    qi = torch.arange(S, device=device)[:, None]
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    return m


def self_attention(p, cfg: ModelConfig, x):
    """Training/prefill full-sequence self-attention; returns (out, (k, v))."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None, :]
    rope = nn.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = _project_q(p, cfg, x, rope)
    k, v = _project_kv(p, cfg, x, rope)
    mask = causal_mask(S, S, cfg.sliding_window, device=x.device)
    out = _sdpa(q, k, v, mask)
    return nn.dense(p["wo"], out.reshape(B, S, -1)), (k, v)


def _write_rows(cache: KVCache, k_new, v_new) -> None:
    """Write row ``length[b]`` of each sequence's K and V in place.

    A row whose length has reached ``S_max`` keeps its cache: an idle slot
    of the batcher decodes on and its length grows past ``S_max``, where the
    reference drops the write (``.at[...].set(mode="drop")``).  An
    out-of-range ``index_put_`` would be a device-side assert here, so the
    row index is clamped and the old row written back -- no host read of
    the lengths."""
    B, T = cache.k.shape[:2]
    rows = torch.arange(B, device=cache.k.device)
    idx = cache.length.clamp(max=T - 1).long()
    keep = (cache.length < T)[:, None, None]
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        buf[rows, idx] = torch.where(keep, new.to(buf.dtype), buf[rows, idx])


def decode_self_attention(p, cfg: ModelConfig, x, cache: KVCache):
    """One-token decode against a preallocated cache; returns (out, cache).

    ``cache.length`` is per sequence ``(B,)`` so continuous batching mixes
    sequences at different positions.  The K/V tensors are updated in
    place; the returned cache holds them and ``length + 1``."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    rope = nn.rope_angles(cache.length[:, None], cfg.head_dim, cfg.rope_theta)
    q = _project_q(p, cfg, x, rope)
    k_new, v_new = _project_kv(p, cfg, x, rope)
    _write_rows(cache, k_new[:, 0], v_new[:, 0])
    new_len = cache.length + 1
    # kv_len = length + 1: the op clamps its range to the cache length.
    out = da_ops.decode_attention(q[:, 0], cache.k, cache.v, new_len,
                                  window=cfg.sliding_window)
    out = nn.dense(p["wo"], out.reshape(B, 1, -1))
    return out, KVCache(cache.k, cache.v, new_len)


def cross_kv(p, cfg: ModelConfig, memory):
    """The fixed memory's (k, v) ``(B, T, Hkv, dh)``, projected once (no
    RoPE)."""
    return _project_kv(p, cfg, memory, None)


def cross_attention(p, cfg: ModelConfig, x, kv, mem_mask=None):
    """Cross-attention of ``x`` (B, S, d) over precomputed memory ``kv``.

    S > 1 (prefill, teacher forcing) runs ``_sdpa`` over every memory
    position; S == 1 (decode) runs the decode-attention op over all ``T``
    positions (int ``kv_len``).  ``mem_mask`` (B, T) bool, which no caller
    passes, takes the plain ``_sdpa`` path at any S."""
    B, S, _ = x.shape
    k, v = kv
    q = _project_q(p, cfg, x, None)
    if mem_mask is not None:
        out = _sdpa(q, k, v, mem_mask[:, None, None, None, :])
    elif S == 1:
        out = da_ops.decode_attention(q[:, 0], k, v, k.shape[1])
    else:
        out = _sdpa(q, k, v, None)
    return nn.dense(p["wo"], out.reshape(B, S, -1))


def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype,
               device) -> KVCache:
    dh, Hkv = cfg.head_dim, cfg.n_kv_heads
    return KVCache(
        k=torch.zeros((B, S_max, Hkv, dh), dtype=dtype, device=device),
        v=torch.zeros((B, S_max, Hkv, dh), dtype=dtype, device=device),
        length=torch.zeros((B,), dtype=torch.int32, device=device),
    )
