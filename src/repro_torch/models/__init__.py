"""Language-model side of the port: every family of the reference (config,
primitives, self- and cross-attention with the decode-attention kernel,
MoE, the Mamba and RWKV6 scans, the encoder-decoder and vision assembly,
the training forward and loss, analytic counts)."""
from .config import ModelConfig, MoEConfig, SSMConfig, reduced_for_smoke
from .model import Model, init_model

__all__ = ["Model", "ModelConfig", "MoEConfig", "SSMConfig", "init_model",
           "reduced_for_smoke"]
