"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-90B-Vision; unverified].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256; every 5th layer is
a dedicated image cross-attention layer (20 of 100).  Vision frontend is a
stub: input_specs supplies projected patch embeddings (B, 1600, 8192).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vision",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=28_672,
    vocab_size=128_256,
    cross_attn_stride=5,
    n_frontend_tokens=1600,        # 4 tiles x 400 patches, projected
    frontend_dim=8192,
    rope_theta=500_000.0,
    source="hf:meta-llama/Llama-3.2-90B-Vision; unverified",
)
