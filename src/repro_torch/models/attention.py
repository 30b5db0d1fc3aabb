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

On a sharded cache (DTensors placed by ``launch.sharding.cache_shardings``:
rows over the data axes, positions over the model axis, or positions over
every axis at batch 1) each rank writes the new row into its own part and
runs the decode-attention op on its part; where the positions are split,
the parts' outputs merge by their log-sum-exps (``ops.merge``) after one
all-gather of (out, lse) among the ranks that split them.

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
from .shardctx import constrain, is_dtensor, merge_heads, split_heads

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
    q = constrain(split_heads(nn.dense(p["wq"], x, p.get("bq")),
                              cfg.n_heads, cfg.head_dim), "heads")
    if cfg.qk_norm:
        q = nn.rms_norm(p["q_norm"], q, cfg.rms_eps)
    return q if rope is None else nn.apply_rope(q, *rope)


def _project_kv(p, cfg: ModelConfig, x, rope):
    dh, Hkv = cfg.head_dim, cfg.n_kv_heads
    k = constrain(split_heads(nn.dense(p["wk"], x, p.get("bk")), Hkv, dh),
                  "heads")
    v = constrain(split_heads(nn.dense(p["wv"], x, p.get("bv")), Hkv, dh),
                  "heads")
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
    # Context-parallel anchor: query-seq dim over the model axis when head
    # sharding is unavailable (see shardctx "scores").
    scores = constrain(scores, "scores")
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
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    rope = nn.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = _project_q(p, cfg, x, rope)
    k, v = _project_kv(p, cfg, x, rope)
    mask = causal_mask(S, S, cfg.sliding_window, device=x.device)
    out = constrain(_sdpa(q, k, v, mask), "heads")
    return constrain(nn.dense(p["wo"], merge_heads(out)), "resid"), (k, v)


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
    if is_dtensor(cache.k):
        return _decode_sharded(p, cfg, q, k_new, v_new, cache)
    _write_rows(cache, k_new[:, 0], v_new[:, 0])
    new_len = cache.length + 1
    # kv_len = length + 1: the op clamps its range to the cache length.
    out = da_ops.decode_attention(q[:, 0], cache.k, cache.v, new_len,
                                  window=cfg.sliding_window)
    out = nn.dense(p["wo"], out.reshape(B, 1, -1))
    return out, KVCache(cache.k, cache.v, new_len)


def _rows(x):
    """Placements of a tensor split as the rows of the sharded cache ``x``
    are (dim 0 over the same mesh dims), whole on every other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if pl.is_shard(0) else Replicate()
            for pl in x.placements]


def _part_start(x) -> int:
    """The first position (dim 1) of this rank's part of the DTensor
    ``x``: mesh dims that split dim 1 do so in mesh order, major first."""
    mesh, n, idx = x.device_mesh, 1, 0
    coord = mesh.get_coordinate()
    for i, pl in enumerate(x.placements):
        if pl.is_shard(1):
            idx = idx * mesh.shape[i] + coord[i]
            n *= mesh.shape[i]
    part = x.to_local().shape[1]
    if part * n != x.shape[1]:
        raise ValueError(f"positions {x.shape[1]} split unevenly over {n} "
                         f"ranks")
    return idx * part


def _attend_parts(q, k, v, kv_len, window):
    """The decode-attention op on each rank's part of a sharded cache.
    ``q`` (B, 1, H, dh) and ``k``/``v`` (B, T, Hkv, dh) DTensors; ``kv_len``
    this rank's lengths counted from its part's first position (an int or
    (B_local,) tensor; the op clamps them to its part).  Returns (B, H, dh)
    placed as the cache's rows.  Where positions are split, each rank's
    (out, lse) is gathered among the ranks that split them and merged."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh, rows = k.device_mesh, _rows(k)
    split = any(pl.is_shard(1) for pl in k.placements)
    res = da_ops.decode_attention(
        q.redistribute(mesh, rows).to_local()[:, 0], k.to_local(),
        v.to_local(), kv_len, window=window, return_lse=split)
    if not split:
        return DTensor.from_local(res, mesh, rows, run_check=False)
    out, lse = res
    both = torch.cat([out.float(), lse[..., None]], dim=-1)[None]
    spread = [Shard(0) if pl.is_shard(1) else Shard(1) if pl.is_shard(0)
              else Replicate() for pl in k.placements]
    parts = DTensor.from_local(both, mesh, spread, run_check=False)
    parts = parts.redistribute(mesh, [
        Shard(1) if pl.is_shard(0) else Replicate()
        for pl in k.placements]).to_local()
    out = da_ops.merge(parts[..., :-1], parts[..., -1]).to(q.dtype)
    return DTensor.from_local(out, mesh, rows, run_check=False)


def _decode_sharded(p, cfg: ModelConfig, q, k_new, v_new, cache: KVCache):
    """``decode_self_attention`` on a sharded cache: the new row written in
    place into the part that holds position ``length`` (rows past ``S_max``
    keep their cache, as in :func:`_write_rows`), then
    :func:`_attend_parts` at ``kv_len = length + 1``."""
    mesh, rows = cache.k.device_mesh, _rows(cache.k)
    kl, vl = cache.k.to_local(), cache.v.to_local()
    t0 = _part_start(cache.k)
    length = cache.length.redistribute(mesh, rows).to_local()
    at = length.long() - t0
    keep = ((at >= 0) & (at < kl.shape[1]))[:, None, None]
    at = at.clamp(0, kl.shape[1] - 1)
    r = torch.arange(kl.shape[0], device=kl.device)
    for buf, new in ((kl, k_new), (vl, v_new)):
        new = new.redistribute(mesh, rows).to_local()[:, 0]
        buf[r, at] = torch.where(keep, new.to(buf.dtype), buf[r, at])
    out = _attend_parts(q, cache.k, cache.v, length + 1 - t0,
                        cfg.sliding_window)
    B = q.shape[0]
    out = nn.dense(p["wo"], out.reshape(B, 1, -1))
    return out, KVCache(cache.k, cache.v, cache.length + 1)


def cross_kv(p, cfg: ModelConfig, memory):
    """The fixed memory's (k, v) ``(B, T, Hkv, dh)``, projected once (no
    RoPE)."""
    return _project_kv(p, cfg, memory, None)


def cross_attention(p, cfg: ModelConfig, x, kv, mem_mask=None):
    """Cross-attention of ``x`` (B, S, d) over precomputed memory ``kv``.

    S > 1 (prefill, teacher forcing) runs ``_sdpa`` over every memory
    position; S == 1 (decode) runs the decode-attention op over all ``T``
    positions (int ``kv_len``), on each rank's part of a sharded memory.
    ``mem_mask`` (B, T) bool, which no caller passes, takes the plain
    ``_sdpa`` path at any S."""
    B, S, _ = x.shape
    k, v = kv
    q = _project_q(p, cfg, x, None)
    if mem_mask is not None:
        out = _sdpa(q, k, v, mem_mask[:, None, None, None, :])
    elif S == 1 and is_dtensor(k):
        out = _attend_parts(q, k, v, k.shape[1] - _part_start(k), None)
    elif S == 1:
        out = da_ops.decode_attention(q[:, 0], k, v, k.shape[1])
    else:
        out = _sdpa(q, k, v, None)
    return nn.dense(p["wo"], merge_heads(
        out.reshape(B, S, cfg.n_heads, cfg.head_dim)))


def init_cache(cfg: ModelConfig, B: int, S_max: int, dtype,
               device) -> KVCache:
    dh, Hkv = cfg.head_dim, cfg.n_kv_heads
    return KVCache(
        k=torch.zeros((B, S_max, Hkv, dh), dtype=dtype, device=device),
        v=torch.zeros((B, S_max, Hkv, dh), dtype=dtype, device=device),
        length=torch.zeros((B,), dtype=torch.int32, device=device),
    )
