"""SeamlessM4T-large-v2 [arXiv:2308.11596; hf] -- enc-dec, audio frontend
stubbed (input_specs provides precomputed frame embeddings).

24L per stack, d_model=1024 16H (kv=16) d_ff=8192 vocab=256206 (NLLB).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    is_encdec=True,
    n_layers=24,                   # per stack (encoder and decoder)
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=8192,
    vocab_size=256_206,
    n_frontend_tokens=4096,        # default stub frame count (overridden per shape)
    frontend_dim=1024,
    rope_theta=10_000.0,
    source="arXiv:2308.11596; hf",
)
