"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf] -- Mamba:attn 7:1 + MoE.

72L d_model=8192; attention layers every 8th (9 total, 64H GQA kv=8); the
other 63 are Mamba (d_state 16, expand 2, SSD heads of 64).  MoE every other
layer: 16 experts top-2, expert FFN 24576; odd layers dense FFN 24576.
~398B total / ~94B active.  Sub-quadratic => long_500k runs.
"""
from ..models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24_576,
    vocab_size=65_536,
    attn_stride=8,
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=24_576, layer_stride=2),
    ssm=SSMConfig(kind="mamba", d_state=16, expand=2, head_dim=64, chunk=128),
    rope_theta=10_000.0,
    source="arXiv:2403.19887; hf",
)
