"""H2O-Danube-3-4B [arXiv:2401.16818; unverified] -- llama+mistral mix, SWA.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000; sliding window 4096
(mistral-style), head_dim=120 (=3840/32); untied head (the default).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_head=120,
    d_ff=10_240,
    vocab_size=32_000,
    sliding_window=4_096,
    rope_theta=10_000.0,
    source="arXiv:2401.16818; unverified",
)
