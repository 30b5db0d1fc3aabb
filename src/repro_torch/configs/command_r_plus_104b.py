"""Command R+ 104B [hf:CohereForAI/c4ai-command-r-v01; unverified].

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000; no biases,
head_dim=128, rope theta 75e6 (Cohere long-context base).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=33_792,
    vocab_size=256_000,
    qkv_bias=False,
    rope_theta=75_000_000.0,
    source="hf:CohereForAI/c4ai-command-r-plus; unverified",
)
