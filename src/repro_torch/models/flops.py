"""Analytic parameter counts, step FLOPs and weight bytes per architecture
config: the port's own copy of the reference's ``models/flops.py``.

Counts come from the config alone, so a 398 B-parameter config is sized
without allocating it: the serve entry point's memory check and the byte
bounds of decode steps read :func:`weight_bytes`.
"""
from __future__ import annotations

from typing import Dict

from .config import ModelConfig
from .model import _dtype, parse_kind
from .ssm import rwkv_lora


def _attn_params(cfg: ModelConfig, *, bias: bool) -> int:
    d, dh, H, Hkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    n = d * H * dh + 2 * d * Hkv * dh + H * dh * d
    if bias:
        n += H * dh + 2 * Hkv * dh
    if cfg.qk_norm:
        n += 2 * dh
    return n


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    return 3 * cfg.d_model * d_ff


def _moe_params(cfg: ModelConfig) -> int:
    mo = cfg.moe
    n = cfg.d_model * mo.num_experts                       # router
    n += mo.num_experts * 3 * cfg.d_model * mo.d_expert    # routed experts
    n += 3 * cfg.d_model * (mo.d_expert * mo.num_shared)   # shared
    return n


def _mamba_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    H = di // s.head_dim
    return (d * 2 * di + s.conv_width * di + di * 2 * s.d_state
            + di * H + 3 * H + di * d)


def _rwkv_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    lora = rwkv_lora(d)
    tmix = 5 * d + 5 * d * d + d + 2 * d * lora + d + d
    cmix = d + 2 * d * cfg.d_ff
    return tmix + cmix


def _block_params(cfg: ModelConfig, kind: str) -> int:
    mixer, ff = parse_kind(kind)
    d = cfg.d_model
    n = 2 * d                                               # ln1 + ln2
    if mixer == "rwkv":
        return _rwkv_params(cfg) + 2 * d
    if mixer == "mamba":
        n += _mamba_params(cfg)
    elif mixer in ("attn", "cross"):
        n += _attn_params(cfg, bias=cfg.qkv_bias)
    if mixer in ("cross", "xonly"):
        n += d + _attn_params(cfg, bias=False) + 1          # ln_x, xattn, gate
    if ff == "moe":
        n += _moe_params(cfg)
    else:
        n += _mlp_params(cfg, cfg.d_ff)
    return n


def count_params_analytic(cfg: ModelConfig) -> int:
    d = cfg.d_model
    n = cfg.vocab_size * d + d                              # embed + final ln
    if not cfg.tie_embeddings:
        n += d * cfg.vocab_size
    if cfg.is_encdec:
        n += d                                              # enc_norm
        n += cfg.n_layers * _block_params(cfg, "dense")     # encoder
        n += cfg.n_layers * _block_params(cfg, "cross")     # decoder
        return n
    pattern = cfg.layer_pattern
    per_unit = sum(_block_params(cfg, k) for k in pattern)
    return n + cfg.n_pattern_repeats * per_unit


def count_active_analytic(cfg: ModelConfig) -> int:
    """Active params per token (MoE: top_k of num_experts routed)."""
    total = count_params_analytic(cfg)
    if cfg.moe is None:
        return total
    mo = cfg.moe
    n_moe_layers = sum(parse_kind(k)[1] == "moe" for k in cfg.layer_pattern)
    n_moe_layers *= cfg.n_pattern_repeats
    routed = n_moe_layers * mo.num_experts * 3 * cfg.d_model * mo.d_expert
    active_routed = routed * mo.top_k / mo.num_experts
    return int(total - routed + active_routed)


def model_flops(cfg: ModelConfig, *, seq_len: int, global_batch: int,
                kind: str) -> float:
    """MODEL_FLOPS for a whole step: 6 N_active D (train) / 2 N_active D
    (prefill) / 2 N_active per token (decode).  Embedding lookups excluded,
    unembed matmul included via N_active.
    """
    n_active = count_active_analytic(cfg)
    tokens = (seq_len * global_batch if kind in ("train", "prefill")
              else global_batch)
    per_token = 6 * n_active if kind == "train" else 2 * n_active
    flops = float(per_token) * tokens
    # Quadratic attention term: 2 * 2 * S^2 * H * dh per sequence (fwd);
    # x3 for train (fwd+bwd).  SWA replaces S^2 with S*window.
    if cfg.family not in ("ssm",) and kind in ("train", "prefill"):
        n_attn_layers = cfg.n_layers
        if cfg.family == "hybrid":
            n_attn_layers = cfg.n_layers // (cfg.attn_stride or 8)
        S = seq_len
        w = min(cfg.sliding_window or S, S)
        attn = 4.0 * S * w * cfg.n_heads * cfg.head_dim * n_attn_layers * \
            global_batch
        flops += attn * (3.0 if kind == "train" else 1.0)
    return flops


def summary(cfg: ModelConfig) -> Dict[str, float]:
    return {
        "params_total": count_params_analytic(cfg),
        "params_active": count_active_analytic(cfg),
    }


def _small_params(cfg: ModelConfig, kind: str) -> int:
    """1-D leaves of a block: norm gains, biases, per-head SSM scalars and
    RWKV's decay offsets."""
    mixer, _ = parse_kind(kind)
    d = cfg.d_model
    if mixer == "rwkv":
        return 2 * d + 3 * d                    # ln1, ln2; w0, ln_out, mu
    n = 2 * d
    if mixer == "mamba":
        s = cfg.ssm
        n += 3 * (s.expand * d // s.head_dim)   # dt_bias, A_log, D
    else:
        Hq, Hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        n += (Hq + 2 * Hkv if cfg.qkv_bias else 0)
        n += 2 * cfg.head_dim if cfg.qk_norm else 0
    return n


def _f32_matrix_params(cfg: ModelConfig, kind: str) -> int:
    """Matrices a block keeps in f32 whatever the model's dtype: the router,
    RWKV's token-shift mix and bonus."""
    mixer, ff = parse_kind(kind)
    if mixer == "rwkv":
        return 5 * cfg.d_model + cfg.d_model
    return cfg.d_model * cfg.moe.num_experts if ff == "moe" else 0


def weight_bytes(cfg: ModelConfig) -> int:
    """Bytes of a decoder's weight matrices (the f32 ones at 4 bytes, the
    rest in the model's dtype); the 1-D leaves are left out.  A decode step
    reads all of them: the MoE layers' stacked expert product reads every
    expert's weights, whatever the routing."""
    pattern = cfg.layer_pattern
    nr = cfg.n_pattern_repeats
    small = cfg.d_model + nr * sum(_small_params(cfg, k) for k in pattern)
    f32 = nr * sum(_f32_matrix_params(cfg, k) for k in pattern)
    rest = count_params_analytic(cfg) - small - f32
    return rest * _dtype(cfg).itemsize + 4 * f32
