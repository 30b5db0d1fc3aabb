"""Language-model side of the port: the dense decoder-only family (config,
primitives, attention with the decode-attention kernel, assembly)."""
from .config import ModelConfig, MoEConfig, SSMConfig, reduced_for_smoke

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "reduced_for_smoke"]
