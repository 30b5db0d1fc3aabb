"""Model assembly for every decoder-only layer kind of the reference:

  dense        self-attn (causal / SWA / GQA / qk_norm / bias) + SwiGLU
  moe          self-attn + token-choice top-k MoE (opt. shared experts)
  attn+dense / attn+moe / mamba+dense / mamba+moe      (Jamba hybrid unit)
  rwkv         RWKV6 time-mix + channel-mix

Parameters are a dict of tensors with one entry per layer (``"layers"``, a
list), where the reference stacks each pattern position over repeats and
runs ``lax.scan``; a Python loop over the layers takes its place, and layer
``j`` has kind ``cfg.layer_pattern[j % len(pattern)]``.  Cross-attention
(``xonly``/``cross``) and encoder-decoder configs raise
``NotImplementedError``.

Entry points (functions of a params dict):
  init_model(cfg, seed, device)            -> params
  train_logits(cfg, params, batch)         -> (logits, aux)   forward only
  prefill(cfg, params, batch)              -> (last logits, raw caches, None)
  decode_step(cfg, params, token, caches)  -> (logits, caches)
  init_caches(cfg, B, S_max, device=...)   -> decode caches
  caches_from_prefill(cfg, raw, S_max)     -> decode caches

Caches hold one entry per layer: a :class:`~.attention.KVCache` for an
attention layer (raw prefill caches: a ``(k, v)`` pair), a
:class:`~.ssm.MambaState` for a Mamba layer and ``{"tmix": RWKVState,
"cmix": shift}`` for an RWKV layer (raw and decode alike).  ``aux`` is the
MoE layers' load-balance losses summed in layer order.  A tied head
(``embed.T * d_model**-0.5`` in the parameter dtype) is formed once and
kept as ``params["tied_head"]``; elementwise scaling gives the same bits
every time, so this equals the reference's per-call product.  An untied
head is ``params["unembed"]`` (d, V), applied as ``x @ unembed``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from . import attention as attn
from . import mlp as mlp_mod
from . import nn, ssm
from .config import ModelConfig

DERIVED = ("tied_head",)        # formed from other params, not counted


def _dtype(cfg: ModelConfig):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def parse_kind(kind: str) -> Tuple[str, str]:
    """kind -> (mixer, ff), the reference's ``_parse_kind``."""
    if "+" in kind:
        mixer, ff = kind.split("+")
        return mixer, ff
    if kind == "rwkv":
        return "rwkv", "cmix"
    if kind == "xonly":
        return "xonly", "dense"
    if kind == "cross":
        return "cross", "dense"
    return "attn", kind            # "dense" | "moe"


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The kind of each layer: layer ``j`` is pattern position ``j % len``."""
    pat = cfg.layer_pattern
    return [pat[j % len(pat)] for j in range(cfg.n_layers)]


def check_supported(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` validated, or ``NotImplementedError`` for what the port does
    not run yet (encoder-decoder and cross-attention layers)."""
    cfg.validate()
    bad = [k for k in cfg.layer_pattern if parse_kind(k)[0] in
           ("xonly", "cross")]
    if cfg.is_encdec or bad:
        raise NotImplementedError(
            f"{cfg.name}: layer pattern {cfg.layer_pattern} (family "
            f"{cfg.family}) is not ported yet: cross-attention and "
            f"encoder-decoder stacks")
    return cfg


def check_prompt_length(cfg: ModelConfig, S: int) -> None:
    """``ValueError`` unless the chunked scans take ``S`` tokens (the
    reference's chunk rule: ``S % min(chunk, S) == 0`` for Mamba,
    ``S % min(chunk, 32, S) == 0`` for RWKV6)."""
    if S < 1:
        raise ValueError(f"a prompt needs at least one token, got {S}")
    mixers = {parse_kind(k)[0] for k in cfg.layer_pattern}
    if "mamba" in mixers:
        ssm.mamba_chunk(cfg, S)
    if "rwkv" in mixers:
        ssm.rwkv_chunk(cfg, S)


def attach_tied_head(cfg: ModelConfig, params: Dict[str, Any]) -> None:
    """Form ``params["tied_head"]`` (V, d): the reference's ``embed.T *
    d_model**-0.5`` in the parameter dtype (a bf16 scale times bf16
    weights, rounded once)."""
    emb = params["embed"]
    scale = torch.tensor(cfg.d_model ** -0.5, dtype=emb.dtype,
                         device=emb.device)
    params["tied_head"] = emb * scale


def _init_block(gen, kind: str, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    mixer, ff = parse_kind(kind)
    p: Dict[str, Any] = {"ln1": nn.rms_norm_init(d, device)}
    if mixer == "rwkv":
        p["tmix"] = ssm.init_rwkv(gen, cfg, dtype, device)
        p["ln2"] = nn.rms_norm_init(d, device)
        p["cmix"] = ssm.init_rwkv_cmix(gen, cfg, dtype, device)
        return p
    if mixer == "mamba":
        p["mixer"] = ssm.init_mamba(gen, cfg, dtype, device)
    else:
        p["mixer"] = attn.init_attn(gen, cfg, dtype, device)
    p["ln2"] = nn.rms_norm_init(d, device)
    if ff == "moe":
        p["ff"] = mlp_mod.init_moe(gen, cfg, dtype, device)
    else:
        p["ff"] = mlp_mod.init_mlp(gen, d, cfg.d_ff, dtype, device)
    return p


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
    params["layers"] = [_init_block(gen, kind, cfg, dtype, device)
                        for kind in layer_kinds(cfg)]
    if cfg.tie_embeddings:
        attach_tied_head(cfg, params)
    else:
        params["unembed"] = nn.dense_init(gen, d, cfg.vocab_size, dtype,
                                          device)
    return params


def _apply_block(p, kind: str, cfg: ModelConfig, x, *, cache):
    """Prefill/train (``cache`` None) or decode; returns (x, layer cache,
    the MoE aux loss or None)."""
    mixer, ff = parse_kind(kind)
    aux = None
    h = nn.rms_norm(p["ln1"], x, cfg.rms_eps)
    if mixer == "rwkv":
        if cache is None:
            y, tstate = ssm.rwkv_forward(p["tmix"], cfg, h, None)
            shift = torch.zeros((x.shape[0], 1, cfg.d_model), dtype=x.dtype,
                                device=x.device)
        else:
            y, tstate = ssm.rwkv_decode(p["tmix"], cfg, h, cache["tmix"])
            shift = cache["cmix"]
        x = x + y
        h2 = nn.rms_norm(p["ln2"], x, cfg.rms_eps)
        y2, new_shift = ssm.rwkv_cmix(p["cmix"], cfg, h2, shift)
        return x + y2, {"tmix": tstate, "cmix": new_shift}, aux
    if mixer == "mamba":
        if cache is None:
            y, new_cache = ssm.mamba_forward(p["mixer"], cfg, h, None)
        else:
            y, new_cache = ssm.mamba_decode(p["mixer"], cfg, h, cache)
    elif cache is None:
        y, new_cache = attn.self_attention(p["mixer"], cfg, h)
    else:
        y, new_cache = attn.decode_self_attention(p["mixer"], cfg, h, cache)
    x = x + y
    h2 = nn.rms_norm(p["ln2"], x, cfg.rms_eps)
    if ff == "moe":
        y2, aux = mlp_mod.moe(p["ff"], cfg, h2)
    else:
        y2 = mlp_mod.mlp(p["ff"], h2)
    return x + y2, new_cache, aux


def _run_stack(cfg, params, x, caches=None):
    """(x, new caches, the MoE layers' aux losses in layer order)."""
    new_caches, auxes = [], []
    for i, (p, kind) in enumerate(zip(params["layers"], layer_kinds(cfg))):
        x, c, a = _apply_block(p, kind, cfg, x,
                               cache=None if caches is None else caches[i])
        new_caches.append(c)
        if a is not None:
            auxes.append(a)
    return x, new_caches, auxes


def _embed(cfg, params, tokens):
    return params["embed"][tokens]


def _unembed(cfg, params, x):
    if cfg.tie_embeddings:
        return torch.nn.functional.linear(x, params["tied_head"])
    return torch.matmul(x, params["unembed"])


def train_logits(cfg: ModelConfig, params, batch):
    """Full teacher-forcing forward (no gradient).  Returns (logits, aux);
    aux is the MoE layers' summed load-balance loss (0 without MoE)."""
    check_supported(cfg)
    with torch.no_grad():
        x = _embed(cfg, params, batch["tokens"])
        x, _, auxes = _run_stack(cfg, params, x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for a in auxes:
            aux = aux + a
        x = nn.rms_norm(params["final_norm"], x, cfg.rms_eps)
        return _unembed(cfg, params, x), aux


def prefill(cfg: ModelConfig, params, batch):
    """Full forward returning (last logits (B, 1, V), raw caches, memory);
    raw caches hold one entry per layer (a (k, v) pair (B, S, Hkv, dh) for
    attention, the final state for Mamba and RWKV), memory is None (no
    cross-attention)."""
    check_supported(cfg)
    with torch.no_grad():
        x = _embed(cfg, params, batch["tokens"])
        x, caches, _ = _run_stack(cfg, params, x)
        x = nn.rms_norm(params["final_norm"], x[:, -1:], cfg.rms_eps)
        return _unembed(cfg, params, x), caches, None


def decode_step(cfg: ModelConfig, params, token, caches):
    """One token for the whole stack.  token (B, 1) -> (logits (B, 1, V),
    caches); attention layers update their K/V tensors in place, Mamba and
    RWKV layers return new states."""
    with torch.no_grad():
        x = _embed(cfg, params, token)
        x, new_caches, _ = _run_stack(cfg, params, x, caches)
        x = nn.rms_norm(params["final_norm"], x, cfg.rms_eps)
        return _unembed(cfg, params, x), new_caches


def init_caches(cfg: ModelConfig, B: int, S_max: int, *, length: int = 0,
                device="cuda") -> List[Any]:
    """Decode caches, one per layer; attention layers' lengths set to
    ``length``, recurrent states zero."""
    check_supported(cfg)
    dtype = _dtype(cfg)
    out: List[Any] = []
    for kind in layer_kinds(cfg):
        mixer, _ = parse_kind(kind)
        if mixer == "rwkv":
            out.append({"tmix": ssm.init_rwkv_state(cfg, B, dtype, device),
                        "cmix": torch.zeros((B, 1, cfg.d_model),
                                            dtype=dtype, device=device)})
        elif mixer == "mamba":
            out.append(ssm.init_mamba_state(cfg, B, dtype, device))
        else:
            c = attn.init_cache(cfg, B, S_max, dtype, device)
            out.append(c._replace(length=torch.full(
                (B,), length, dtype=torch.int32, device=device)))
    return out


def caches_from_prefill(cfg: ModelConfig, raw_caches, S_max: int):
    """Prefill's (k, v) pairs of length S zero-padded to S_max, length S;
    recurrent states pass through unchanged."""
    out = []
    for kind, c in zip(layer_kinds(cfg), raw_caches):
        if parse_kind(kind)[0] != "attn":
            out.append(c)
            continue
        k, v = c
        B, S = k.shape[:2]
        pad = (0, 0, 0, 0, 0, S_max - S)
        out.append(attn.KVCache(
            torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad),
            torch.full((B,), S, dtype=torch.int32, device=k.device)))
    return out


def _leaves(p, prefix=""):
    """(path, tensor) of every parameter, derived tensors left out."""
    if isinstance(p, dict):
        for key, val in p.items():
            if key not in DERIVED:
                yield from _leaves(val, f"{prefix}/{key}")
    elif isinstance(p, (list, tuple)):
        for i, val in enumerate(p):
            yield from _leaves(val, f"{prefix}/{i}")
    else:
        yield prefix, p


def count_params(params) -> int:
    """Parameter count, derived tensors (the tied head) excluded."""
    return int(sum(t.numel() for _, t in _leaves(params)))


def count_active_params(cfg: ModelConfig, params) -> int:
    """Active params per token (MoE: only top_k of num_experts count)."""
    total = count_params(params)
    if cfg.moe is None:
        return total
    expert_total = sum(t.numel() for k, t in _leaves(params)
                       if k.endswith(("we_gate", "we_up", "we_down")))
    active_frac = cfg.moe.top_k / cfg.moe.num_experts
    return int(total - expert_total * (1.0 - active_frac))
