"""Model configuration: the port's own copy of the reference's dataclasses.

One frozen dataclass describes every architecture of the registry; the port
runs every decoder-only family (dense, MoE, SSM, hybrid) and raises on
cross-attention and encoder-decoder configs where a layer kind is built.  The fields, defaults, ``layer_pattern`` and
``reduced_for_smoke`` are those of the reference, so a configuration means
the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    num_shared: int = 0           # always-on shared experts (DeepSeekMoE)
    layer_stride: int = 1         # MoE every k-th layer (Jamba: 2)
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str                     # "rwkv6" | "mamba"
    d_state: int = 16             # mamba state dim N
    expand: int = 2               # mamba d_inner = expand * d_model
    head_dim: int = 64            # rwkv6 head size / mamba SSD head P
    conv_width: int = 4           # mamba local conv
    chunk: int = 128              # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vision
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (Jamba): one attention layer per `attn_stride` layers, rest SSM.
    attn_stride: Optional[int] = None
    # encoder-decoder (seamless): n_layers applies to EACH stack.
    is_encdec: bool = False
    # vision (llama-3.2-V): cross-attention layer every `cross_attn_stride`.
    cross_attn_stride: Optional[int] = None
    n_frontend_tokens: int = 0    # stubbed modality tokens (frames / patches)
    frontend_dim: int = 0         # stub embedding width (= d_model here)
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def layer_pattern(self) -> Tuple[str, ...]:
        """Repeating unit of layer kinds (the reference's scan unit)."""
        if self.family == "ssm":
            return ("rwkv",)
        if self.family == "hybrid":
            stride = self.attn_stride or 8
            moe_stride = self.moe.layer_stride if self.moe else 0
            pat = []
            for i in range(stride):
                kind = "attn" if (i + 1) % stride == 0 else "mamba"
                ff = "moe" if self.moe and (i % moe_stride == moe_stride - 1) else "dense"
                pat.append(f"{kind}+{ff}")
            return tuple(pat)
        if self.family == "vision":
            stride = self.cross_attn_stride or 5
            return tuple(
                "xonly" if (i + 1) % stride == 0 else "dense"
                for i in range(stride)
            )
        if self.family == "moe":
            return ("moe",)
        return ("dense",)

    @property
    def n_pattern_repeats(self) -> int:
        pat = len(self.layer_pattern)
        if self.n_layers % pat:
            raise ValueError(
                f"{self.name}: n_layers {self.n_layers} not divisible by "
                f"pattern {pat}")
        return self.n_layers // pat

    def validate(self) -> "ModelConfig":
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads {self.n_heads} not a "
                             f"multiple of n_kv_heads {self.n_kv_heads}")
        if self.family in ("moe", "hybrid") and self.moe is None:
            raise ValueError(f"{self.name}: family {self.family} needs moe cfg")
        if self.family in ("ssm", "hybrid") and self.ssm is None:
            raise ValueError(f"{self.name}: family {self.family} needs ssm cfg")
        _ = self.n_pattern_repeats
        return self


def reduced_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU tests (the reference's reduction)."""
    pat = len(cfg.layer_pattern)
    small = dict(
        n_layers=max(pat, 2 if pat == 1 else pat),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, 4 // max(1, cfg.n_heads // cfg.n_kv_heads)),
        d_head=32,
        d_ff=256,
        vocab_size=512,
        n_frontend_tokens=min(cfg.n_frontend_tokens, 16),
        frontend_dim=128 if cfg.frontend_dim else 0,
        dtype="float32",
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2), d_expert=64)
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=8, head_dim=16, chunk=16)
    small.update(overrides)
    return dataclasses.replace(cfg, **small).validate()
