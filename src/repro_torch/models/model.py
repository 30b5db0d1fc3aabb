"""Model assembly for every layer kind of the reference:

  dense        self-attn (causal / SWA / GQA / qk_norm / bias) + SwiGLU
  moe          self-attn + token-choice top-k MoE (opt. shared experts)
  attn+dense / attn+moe / mamba+dense / mamba+moe      (Jamba hybrid unit)
  rwkv         RWKV6 time-mix + channel-mix
  xonly        cross-attn + SwiGLU (Llama-3.2-Vision image layers)
  cross        self-attn + cross-attn + SwiGLU (encoder-decoder decoder)

Parameters are a dict of tensors with one entry per layer (``"layers"``, a
list), where the reference stacks each pattern position over repeats and
runs ``lax.scan``; a Python loop over the layers takes its place, and layer
``j`` has kind ``cfg.layer_pattern[j % len(pattern)]``.  An
encoder-decoder config (``is_encdec``) holds ``"enc"`` (n_layers ``dense``
layers run bidirectionally over the frames), ``"enc_norm"`` and ``"dec"``
(n_layers ``cross`` layers) in place of ``"layers"``.  The cross-attention
memory is the encoded frames (enc-dec) or ``batch["image_embeds"]``
(vision), cast to the model's dtype (the reference passes the embeddings
as they come; a torch product takes one dtype).  A cross branch adds
``tanh(xgate) * y`` to the residual.

Entry points (functions of a params dict):
  init_model(cfg, seed, device)            -> params
  train_logits(cfg, params, batch, remat)  -> (logits, aux)
  loss_fn(cfg, params, batch, remat)       -> scalar loss (+ the aux loss)
  prefill(cfg, params, batch)              -> (last logits, raw caches,
                                               memory or None)
  decode_step(cfg, params, token, caches)  -> (logits, caches)
  init_caches(cfg, B, S_max, mem_len, device=...) -> decode caches
  caches_from_prefill(cfg, raw, S_max)     -> decode caches

``train_logits`` and ``loss_fn`` record a graph when the caller's leaves
require grad (the train step's do; served weights do not); ``prefill`` and
``decode_step`` never do.  ``remat`` recomputes each layer in the backward
pass (``torch.utils.checkpoint``): ``"full"`` saves nothing of a layer,
``"dots"`` saves its matmul outputs, ``"dots_no_batch"`` those without a
batch dimension (the reference's ``REMAT_POLICIES``); it changes no value.

Caches hold one entry per decoder layer: a :class:`~.attention.KVCache` for
an attention layer (raw prefill caches: a ``(k, v)`` pair), a
:class:`~.ssm.MambaState` for a Mamba layer, ``{"tmix": RWKVState, "cmix":
shift}`` for an RWKV layer (raw and decode alike), ``{"mixer": KVCache,
"xkv": (k, v)}`` for a cross layer (raw: ``{"mixer": (k, v), "xkv": (k,
v)}``) and ``{"xkv": (k, v)}`` for an xonly layer, the memory's projected
K/V ``(B, T, Hkv, dh)`` passing through decode unchanged.  ``aux`` is the
MoE layers' load-balance losses summed in layer order.  A tied head
(``embed.T * d_model**-0.5`` in the parameter dtype) is kept as
``params["tied_head"]`` for serving: elementwise scaling gives the same
bits every time, so this equals the reference's per-call product.  It is
derived, never a trainable leaf: a differentiable forward forms it from
``embed`` in the graph, as the reference does, so the embedding receives
the head's gradient, and the train step re-attaches it after each update.
An untied head is ``params["unembed"]`` (d, V), applied as ``x @
unembed``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt_util

from . import attention as attn
from . import mlp as mlp_mod
from . import nn, ssm
from .config import ModelConfig
from .shardctx import constrain, embed_lookup, grad_placed

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
    """The kind of each decoder layer: layer ``j`` is pattern position ``j %
    len``; every layer of an encoder-decoder's decoder is ``cross``."""
    if cfg.is_encdec:
        return ["cross"] * cfg.n_layers
    pat = cfg.layer_pattern
    return [pat[j % len(pat)] for j in range(cfg.n_layers)]


def check_servable(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` validated, or ``ValueError`` for an encoder-decoder or vision
    config: the batcher carries no memory, as in the reference, whose serve
    demo refuses them."""
    cfg.validate()
    if cfg.is_encdec or cfg.family == "vision":
        raise ValueError(f"{cfg.name}: serve demo targets decoder-only archs")
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


def _tied_head(cfg: ModelConfig, emb: torch.Tensor) -> torch.Tensor:
    """The reference's ``embed.T * d_model**-0.5`` as (V, d), in the
    parameter dtype (a bf16 scale times bf16 weights, rounded once)."""
    scale = torch.tensor(cfg.d_model ** -0.5, dtype=emb.dtype,
                         device=emb.device)
    return emb * scale


def attach_tied_head(cfg: ModelConfig, params: Dict[str, Any]) -> None:
    """Form ``params["tied_head"]`` from ``params["embed"]`` (no graph)."""
    with torch.no_grad():
        params["tied_head"] = _tied_head(cfg, params["embed"])


def trainable(params: Dict[str, Any]) -> Dict[str, Any]:
    """``params`` without its derived tensors: the tree an optimizer
    updates."""
    return {k: v for k, v in params.items() if k not in DERIVED}


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
    elif mixer != "xonly":
        p["mixer"] = attn.init_attn(gen, cfg, dtype, device)
    if mixer in ("cross", "xonly"):
        p["ln_x"] = nn.rms_norm_init(d, device)
        p["xattn"] = attn.init_attn(gen, cfg, dtype, device, cross=True)
        p["xgate"] = torch.zeros((1,), dtype=torch.float32, device=device)
    p["ln2"] = nn.rms_norm_init(d, device)
    if ff == "moe":
        p["ff"] = mlp_mod.init_moe(gen, cfg, dtype, device)
    else:
        p["ff"] = mlp_mod.init_mlp(gen, d, cfg.d_ff, dtype, device)
    return p


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda",
               place=None) -> Dict[str, Any]:
    """Random weights drawn on ``device`` from a ``torch.Generator`` seeded
    with ``seed`` (the reference's initialisers; other random numbers).  On
    the ``meta`` device the tree carries shapes and dtypes only (the
    reference's ``eval_shape`` of its initialiser).

    ``place(path, subtree)``, when given, receives each part as soon as it
    is drawn -- the embedding, each layer (``"layers/<i>"``), each norm,
    the untied head -- and returns what the tree keeps (its shards: see
    ``launch.sharding.placer``), so no more than one full part is held
    beyond the shards.  The draws are the same with or without it."""
    cfg.validate()
    dtype = _dtype(cfg)
    gen = (None if torch.device(device).type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    put = place or (lambda path, tree: tree)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": put("embed", nn.embed_init(gen, cfg.vocab_size, d, dtype,
                                            device)),
        "final_norm": put("final_norm", nn.rms_norm_init(d, device)),
    }

    def stack(name, kinds):
        return [put(f"{name}/{i}", _init_block(gen, kind, cfg, dtype,
                                                device))
                for i, kind in enumerate(kinds)]

    if cfg.is_encdec:
        params["enc"] = stack("enc", ["dense"] * cfg.n_layers)
        params["enc_norm"] = put("enc_norm", nn.rms_norm_init(d, device))
        params["dec"] = stack("dec", layer_kinds(cfg))
    else:
        params["layers"] = stack("layers", layer_kinds(cfg))
    if cfg.tie_embeddings:
        attach_tied_head(cfg, params)
    else:
        params["unembed"] = put("unembed", nn.dense_init(
            gen, d, cfg.vocab_size, dtype, device))
    return params


def _apply_block(p, kind: str, cfg: ModelConfig, x, *, cache, memory=None,
                 bidirectional: bool = False):
    """Prefill/train (``cache`` None; ``memory`` the cross layers' memory)
    or decode; returns (x, layer cache, the MoE aux loss or None)."""
    mixer, ff = parse_kind(kind)
    aux = None
    x = constrain(x, "resid")
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
    if mixer in ("cross", "xonly"):
        x, new_cache = _cross_block(p, cfg, x, h, mixer, cache, memory)
    else:
        if mixer == "mamba":
            if cache is None:
                y, new_cache = ssm.mamba_forward(p["mixer"], cfg, h, None)
            else:
                y, new_cache = ssm.mamba_decode(p["mixer"], cfg, h, cache)
        elif cache is not None:
            y, new_cache = attn.decode_self_attention(p["mixer"], cfg, h,
                                                      cache)
        elif bidirectional:
            y, new_cache = _bidir_attention(p["mixer"], cfg, h)
        else:
            y, new_cache = attn.self_attention(p["mixer"], cfg, h)
        x = x + y
    h2 = nn.rms_norm(p["ln2"], x, cfg.rms_eps)
    if ff == "moe":
        y2, aux = mlp_mod.moe(p["ff"], cfg, h2)
    else:
        y2 = mlp_mod.mlp(p["ff"], h2)
    return x + y2, new_cache, aux


def _cross_block(p, cfg: ModelConfig, x, h, mixer: str, cache, memory):
    """A cross or xonly layer's mixers (``h`` is ``ln1(x)``): self-attention
    first for ``cross``, then the gated cross-attention over the memory (its
    K/V projected here in prefill, read from the cache in decode).  Returns
    (x, the layer's cache dict)."""
    new_cache: Dict[str, Any] = {}
    if mixer == "cross":
        if cache is None:
            y, new_cache["mixer"] = attn.self_attention(p["mixer"], cfg, h)
        else:
            y, new_cache["mixer"] = attn.decode_self_attention(
                p["mixer"], cfg, h, cache["mixer"])
        x = x + y
    hx = nn.rms_norm(p["ln_x"], x, cfg.rms_eps)
    xkv = (attn.cross_kv(p["xattn"], cfg, memory) if cache is None
           else cache["xkv"])
    yx = attn.cross_attention(p["xattn"], cfg, hx, xkv)
    new_cache["xkv"] = xkv
    return x + torch.tanh(p["xgate"]).to(x.dtype) * yx, new_cache


def _bidir_attention(p, cfg: ModelConfig, x):
    """Full bidirectional self-attention (the encoder stack): RoPE at
    positions ``arange(S)``, every key attended."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    rope = nn.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    q = attn._project_q(p, cfg, x, rope)
    k, v = attn._project_kv(p, cfg, x, rope)
    out = attn._sdpa(q, k, v, None)
    return nn.dense(p["wo"], attn.merge_heads(out)), (k, v)


# Ops whose outputs each remat policy saves (aten names; the port's
# matmuls lower to ``mm``/``addmm``, its einsums to ``bmm``).  None: save
# nothing, recompute the whole layer.
REMAT_POLICIES = {
    "full": None,
    "dots": ("mm", "addmm", "bmm"),
    "dots_no_batch": ("mm", "addmm"),
}


def _remat_context(remat: str):
    """``context_fn`` of ``torch.utils.checkpoint`` for a policy name."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; have "
                         f"{sorted(REMAT_POLICIES)}")
    names = REMAT_POLICIES[remat]
    if names is None:
        return ckpt_util.noop_context_fn
    saved = tuple(getattr(torch.ops.aten, n).default for n in names)

    def policy(ctx, op, *args, **kwargs):
        return (ckpt_util.CheckpointPolicy.MUST_SAVE if op in saved
                else ckpt_util.CheckpointPolicy.PREFER_RECOMPUTE)
    return functools.partial(ckpt_util.create_selective_checkpoint_contexts,
                             policy)


def _train_block(p, kind: str, cfg: ModelConfig, x, memory, remat,
                 bidirectional: bool = False):
    """One layer of a teacher-forcing forward, recomputed in the backward
    pass under ``remat``; returns (x, the MoE aux loss or None)."""
    def body(x_, memory_):
        y, _, aux = _apply_block(p, kind, cfg, x_, cache=None,
                                 memory=memory_, bidirectional=bidirectional)
        return y, aux
    if remat is None or not torch.is_grad_enabled():
        return body(x, memory)
    return ckpt_util.checkpoint(body, x, memory, use_reentrant=False,
                                context_fn=_remat_context(remat))


def _run_stack(cfg, params, x, caches=None, memory=None):
    """The decoder stack: (x, new caches, the MoE layers' aux losses in
    layer order)."""
    new_caches, auxes = [], []
    layers = params["dec"] if cfg.is_encdec else params["layers"]
    for i, (p, kind) in enumerate(zip(layers, layer_kinds(cfg))):
        x, c, a = _apply_block(p, kind, cfg, x, memory=memory,
                               cache=None if caches is None else caches[i])
        new_caches.append(c)
        if a is not None:
            auxes.append(a)
    return x, new_caches, auxes


def _encode(cfg, params, batch, remat=None):
    """The encoder over ``batch["frames"]`` (B, T, d): n_layers dense
    layers run bidirectionally, then ``enc_norm``."""
    h = batch["frames"].to(_dtype(cfg))
    for p in params["enc"]:
        h, _ = _train_block(p, "dense", cfg, h, None, remat,
                            bidirectional=True)
    return nn.rms_norm(params["enc_norm"], h, cfg.rms_eps)


def _memory(cfg, params, batch, remat=None):
    """The cross layers' memory: the encoded frames, the image embeddings
    in the model's dtype, or None."""
    if cfg.is_encdec:
        return _encode(cfg, params, batch, remat)
    if cfg.family == "vision":
        return batch["image_embeds"].to(_dtype(cfg))
    return None


def _embed(cfg, params, tokens):
    return constrain(embed_lookup(params["embed"], tokens), "resid")


def _unembed(cfg, params, x):
    if cfg.tie_embeddings:
        emb = params["embed"]
        head = params.get("tied_head")
        if head is None or (emb.requires_grad and torch.is_grad_enabled()):
            head = _tied_head(cfg, grad_placed(emb))
        return constrain(torch.nn.functional.linear(x, head), "logits")
    return constrain(torch.matmul(x, params["unembed"]), "logits")


def train_logits(cfg: ModelConfig, params, batch, remat=None):
    """Full teacher-forcing forward.  Returns (logits, aux); aux is the MoE
    layers' summed load-balance loss (0 without MoE)."""
    memory = _memory(cfg, params, batch, remat)
    x = _embed(cfg, params, batch["tokens"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = params["dec"] if cfg.is_encdec else params["layers"]
    for p, kind in zip(layers, layer_kinds(cfg)):
        x, a = _train_block(p, kind, cfg, x, memory, remat)
        if a is not None:
            aux = aux + a
    x = nn.rms_norm(params["final_norm"], x, cfg.rms_eps)
    return _unembed(cfg, params, x), aux


def loss_fn(cfg: ModelConfig, params, batch, remat=None) -> torch.Tensor:
    """Mean cross entropy of ``batch["labels"]`` (under
    ``batch["loss_mask"]`` when given) plus the MoE aux loss."""
    logits, aux = train_logits(cfg, params, batch, remat)
    loss = nn.softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
    return loss + aux


def prefill(cfg: ModelConfig, params, batch):
    """Full forward returning (last logits (B, 1, V), raw caches, memory);
    raw caches hold one entry per decoder layer (a (k, v) pair (B, S, Hkv,
    dh) for attention, the final state for Mamba and RWKV, the dicts of
    the module docstring for cross and xonly layers); memory is the
    encoder's output or the image embeddings, None without cross
    layers."""
    with torch.no_grad():
        memory = _memory(cfg, params, batch)
        x = _embed(cfg, params, batch["tokens"])
        x, caches, _ = _run_stack(cfg, params, x, memory=memory)
        x = nn.rms_norm(params["final_norm"], x[:, -1:], cfg.rms_eps)
        return _unembed(cfg, params, x), caches, memory


def decode_step(cfg: ModelConfig, params, token, caches):
    """One token for the whole stack.  token (B, 1) -> (logits (B, 1, V),
    caches); attention layers update their K/V tensors in place, Mamba and
    RWKV layers return new states."""
    with torch.no_grad():
        x = _embed(cfg, params, token)
        x, new_caches, _ = _run_stack(cfg, params, x, caches)
        x = nn.rms_norm(params["final_norm"], x, cfg.rms_eps)
        return _unembed(cfg, params, x), new_caches


def init_caches(cfg: ModelConfig, B: int, S_max: int,
                mem_len: Optional[int] = None, *, length: int = 0,
                device="cuda") -> List[Any]:
    """Decode caches, one per decoder layer; attention layers' lengths set
    to ``length``, recurrent states and cross-KV zero (the cross-KV of
    length ``mem_len or n_frontend_tokens or 1``)."""
    dtype = _dtype(cfg)
    T = mem_len or cfg.n_frontend_tokens or 1
    xkv_shape = (B, T, cfg.n_kv_heads, cfg.head_dim)

    def kv_cache():
        c = attn.init_cache(cfg, B, S_max, dtype, device)
        return c._replace(length=torch.full((B,), length, dtype=torch.int32,
                                            device=device))

    out: List[Any] = []
    for kind in layer_kinds(cfg):
        mixer, _ = parse_kind(kind)
        if mixer == "rwkv":
            out.append({"tmix": ssm.init_rwkv_state(cfg, B, dtype, device),
                        "cmix": torch.zeros((B, 1, cfg.d_model),
                                            dtype=dtype, device=device)})
        elif mixer == "mamba":
            out.append(ssm.init_mamba_state(cfg, B, dtype, device))
        elif mixer == "attn":
            out.append(kv_cache())
        else:
            c = {"xkv": tuple(torch.zeros(xkv_shape, dtype=dtype,
                                          device=device) for _ in range(2))}
            if mixer == "cross":
                c["mixer"] = kv_cache()
            out.append(c)
    return out


def _padded(kv, S_max: int) -> attn.KVCache:
    k, v = kv
    B, S = k.shape[:2]
    pad = (0, 0, 0, 0, 0, S_max - S)
    return attn.KVCache(
        torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad),
        torch.full((B,), S, dtype=torch.int32, device=k.device))


def caches_from_prefill(cfg: ModelConfig, raw_caches, S_max: int):
    """Prefill's (k, v) pairs of length S zero-padded to S_max, length S;
    recurrent states and cross-KV pass through unchanged."""
    out = []
    for kind, c in zip(layer_kinds(cfg), raw_caches):
        mixer = parse_kind(kind)[0]
        if mixer == "attn":
            c = _padded(c, S_max)
        elif mixer == "cross":
            c = dict(c, mixer=_padded(c["mixer"], S_max))
        out.append(c)
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


class Model:
    """Thin OO veneer used by examples and the launcher."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg.validate()

    def init(self, seed: int = 0, device="cuda"):
        return init_model(self.cfg, seed, device)

    def loss(self, params, batch):
        return loss_fn(self.cfg, params, batch)

    def logits(self, params, batch):
        return train_logits(self.cfg, params, batch)

    def prefill(self, params, batch):
        return prefill(self.cfg, params, batch)

    def decode(self, params, token, caches):
        return decode_step(self.cfg, params, token, caches)

    def init_caches(self, B, S_max, mem_len=None, length: int = 0,
                    device="cuda"):
        return init_caches(self.cfg, B, S_max, mem_len, length=length,
                           device=device)
