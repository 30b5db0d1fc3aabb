"""DeepSeekMoE-16B [arXiv:2401.06066; hf] -- fine-grained + shared experts.

28L d_model=2048 16H (kv=16, i.e. MHA) vocab=102400; MoE: 64 routed experts
top-6 + 2 shared experts, expert FFN dim 1408.
"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,                     # per-expert dim
    vocab_size=102_400,
    moe=MoEConfig(num_experts=64, top_k=6, d_expert=1408, num_shared=2),
    rope_theta=10_000.0,
    source="arXiv:2401.06066; hf",
)
