"""Language-model side of the port: every family of the reference (config,
primitives, self- and cross-attention with the decode-attention kernel,
MoE, the Mamba and RWKV6 scans, the encoder-decoder and vision assembly,
analytic counts)."""
from .config import ModelConfig, MoEConfig, SSMConfig, reduced_for_smoke

__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "reduced_for_smoke"]
