"""RWKV6-World-7B (Finch) [arXiv:2404.05892; hf] -- attention-free,
data-dependent decay.

32L d_model=4096 d_ff=14336 vocab=65536; head size 64 (64 heads).
Sub-quadratic (O(1) state) => long_500k runs.
"""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                    # = d_model / head_dim (bookkeeping only)
    n_kv_heads=64,
    d_head=64,
    d_ff=14_336,
    vocab_size=65_536,
    ssm=SSMConfig(kind="rwkv6", head_dim=64, chunk=32),
    source="arXiv:2404.05892; hf",
)
