"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family; hf] -- GQA with qk_norm.

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936; per-head RMS
q/k norm (the Qwen3 signature), head_dim=128, tied embeddings.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=6144,
    vocab_size=151_936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-1.7B; hf",
)
