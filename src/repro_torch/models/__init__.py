"""Language-model side of the port: every decoder-only family (config,
primitives, attention with the decode-attention kernel, MoE, the Mamba and
RWKV6 scans, assembly, analytic counts)."""
from .config import ModelConfig, MoEConfig, SSMConfig, reduced_for_smoke

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "reduced_for_smoke"]
