"""Model assembly for the dense decoder-only family: full or sliding-window
attention, optional QK norm, a tied or untied head.

Parameters are a dict of tensors with one entry per layer (``"layers"``, a
list), where the reference stacks each pattern position over repeats and
runs ``lax.scan``; a Python loop over the layers takes its place.  Layer
kinds other than ``dense`` (MoE, SSM/hybrid, cross-attention,
encoder-decoder) raise ``NotImplementedError``.

Entry points (functions of a params dict):
  init_model(cfg, seed, device)            -> params
  train_logits(cfg, params, batch)         -> (logits, aux)   forward only
  prefill(cfg, params, batch)              -> (last logits, raw caches, None)
  decode_step(cfg, params, token, caches)  -> (logits, caches)
  init_caches(cfg, B, S_max, device=...)   -> decode caches
  caches_from_prefill(cfg, raw, S_max)     -> decode caches

Caches are one :class:`~.attention.KVCache` per layer; raw prefill caches
one ``(k, v)`` pair per layer.  A tied head (``embed.T * d_model**-0.5`` in
the parameter dtype) is formed once and kept as ``params["tied_head"]``;
elementwise scaling gives the same bits every time, so this equals the
reference's per-call product.  An untied head is ``params["unembed"]`` (d,
V), applied as ``x @ unembed``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from . import attention as attn
from . import mlp as mlp_mod
from . import nn
from .config import ModelConfig

DERIVED = ("tied_head",)        # formed from other params, not counted


def _dtype(cfg: ModelConfig):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def check_supported(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` validated, or ``NotImplementedError`` for what the port does
    not run yet."""
    cfg.validate()
    if cfg.is_encdec or cfg.layer_pattern != ("dense",):
        raise NotImplementedError(
            f"{cfg.name}: layer pattern {cfg.layer_pattern} (family "
            f"{cfg.family}) is not ported yet; only dense decoders are")
    return cfg


def attach_tied_head(cfg: ModelConfig, params: Dict[str, Any]) -> None:
    """Form ``params["tied_head"]`` (V, d): the reference's ``embed.T *
    d_model**-0.5`` in the parameter dtype (a bf16 scale times bf16
    weights, rounded once)."""
    emb = params["embed"]
    scale = torch.tensor(cfg.d_model ** -0.5, dtype=emb.dtype,
                         device=emb.device)
    params["tied_head"] = emb * scale


def init_model(cfg: ModelConfig, seed: int = 0,
               device="cuda") -> Dict[str, Any]:
    """Random weights drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` (the reference's initialisers; other random numbers)."""
    check_supported(cfg)
    dtype = _dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": nn.embed_init(gen, cfg.vocab_size, d, dtype, device),
        "final_norm": nn.rms_norm_init(d, device),
    }
    params["layers"] = [{
        "ln1": nn.rms_norm_init(d, device),
        "mixer": attn.init_attn(gen, cfg, dtype, device),
        "ln2": nn.rms_norm_init(d, device),
        "ff": mlp_mod.init_mlp(gen, d, cfg.d_ff, dtype, device),
    } for _ in range(cfg.n_layers)]
    if cfg.tie_embeddings:
        attach_tied_head(cfg, params)
    else:
        params["unembed"] = nn.dense_init(gen, d, cfg.vocab_size, dtype,
                                          device)
    return params


def _apply_block(p, cfg: ModelConfig, x, *, cache: Optional[attn.KVCache]):
    """Prefill/train (``cache`` None) or decode; returns (x, layer cache)."""
    h = nn.rms_norm(p["ln1"], x, cfg.rms_eps)
    if cache is None:
        y, new_cache = attn.self_attention(p["mixer"], cfg, h)
    else:
        y, new_cache = attn.decode_self_attention(p["mixer"], cfg, h, cache)
    x = x + y
    h2 = nn.rms_norm(p["ln2"], x, cfg.rms_eps)
    return x + mlp_mod.mlp(p["ff"], h2), new_cache


def _run_stack(cfg, params, x, caches=None):
    new_caches = []
    for i, p in enumerate(params["layers"]):
        x, c = _apply_block(p, cfg, x,
                            cache=None if caches is None else caches[i])
        new_caches.append(c)
    return x, new_caches


def _embed(cfg, params, tokens):
    return params["embed"][tokens]


def _unembed(cfg, params, x):
    if cfg.tie_embeddings:
        return torch.nn.functional.linear(x, params["tied_head"])
    return torch.matmul(x, params["unembed"])


def train_logits(cfg: ModelConfig, params, batch):
    """Full teacher-forcing forward (no gradient).  Returns (logits, aux);
    aux is the dense family's zero auxiliary loss."""
    check_supported(cfg)
    with torch.no_grad():
        x = _embed(cfg, params, batch["tokens"])
        x, _ = _run_stack(cfg, params, x)
        x = nn.rms_norm(params["final_norm"], x, cfg.rms_eps)
        logits = _unembed(cfg, params, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def prefill(cfg: ModelConfig, params, batch):
    """Full forward returning (last logits (B, 1, V), raw caches, memory);
    raw caches are one (k, v) pair (B, S, Hkv, dh) per layer, memory is
    None (no cross-attention)."""
    check_supported(cfg)
    with torch.no_grad():
        x = _embed(cfg, params, batch["tokens"])
        x, caches = _run_stack(cfg, params, x)
        x = nn.rms_norm(params["final_norm"], x[:, -1:], cfg.rms_eps)
        return _unembed(cfg, params, x), caches, None


def decode_step(cfg: ModelConfig, params, token, caches):
    """One token for the whole stack.  token (B, 1) -> (logits (B, 1, V),
    caches); the caches' K/V tensors are updated in place."""
    with torch.no_grad():
        x = _embed(cfg, params, token)
        x, new_caches = _run_stack(cfg, params, x, caches)
        x = nn.rms_norm(params["final_norm"], x, cfg.rms_eps)
        return _unembed(cfg, params, x), new_caches


def init_caches(cfg: ModelConfig, B: int, S_max: int, *, length: int = 0,
                device="cuda") -> List[attn.KVCache]:
    """Decode caches, one per layer, with lengths set to ``length``."""
    check_supported(cfg)
    out = []
    for _ in range(cfg.n_layers):
        c = attn.init_cache(cfg, B, S_max, _dtype(cfg), device)
        out.append(c._replace(length=torch.full(
            (B,), length, dtype=torch.int32, device=device)))
    return out


def caches_from_prefill(cfg: ModelConfig, raw_caches,
                        S_max: int) -> List[attn.KVCache]:
    """Prefill's (k, v) pairs of length S zero-padded to S_max, length S."""
    out = []
    for k, v in raw_caches:
        B, S = k.shape[:2]
        pad = (0, 0, 0, 0, 0, S_max - S)
        out.append(attn.KVCache(
            torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad),
            torch.full((B,), S, dtype=torch.int32, device=k.device)))
    return out


def weight_bytes(cfg: ModelConfig) -> int:
    """Bytes of a dense model's weights in its dtype (norm gains and biases
    left out), from the config alone."""
    d, dh, V = cfg.d_model, cfg.head_dim, cfg.vocab_size
    attn_w = d * dh * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    layer = attn_w + 3 * d * cfg.d_ff
    heads = (1 if cfg.tie_embeddings else 2) * V * d
    return (cfg.n_layers * layer + heads) * _dtype(cfg).itemsize


def count_params(params) -> int:
    """Parameter count, derived tensors (the tied head) excluded."""
    def leaves(p):
        if isinstance(p, dict):
            for key, val in p.items():
                if key not in DERIVED:
                    yield from leaves(val)
        elif isinstance(p, (list, tuple)):
            for val in p:
                yield from leaves(val)
        else:
            yield p
    return int(sum(t.numel() for t in leaves(params)))
