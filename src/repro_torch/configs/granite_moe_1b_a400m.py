"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (GQA kv=8) vocab=49155; MoE: 32 experts, top-8,
expert FFN dim 512 (fine-grained), no shared experts.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=512,                      # per-expert dim (dense d_ff unused)
    vocab_size=49_155,
    moe=MoEConfig(num_experts=32, top_k=8, d_expert=512),
    tie_embeddings=True,
    rope_theta=10_000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
