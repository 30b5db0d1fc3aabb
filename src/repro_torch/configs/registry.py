"""Architecture registry of the port: ``get_config(arch)`` for the archs it
runs -- every decoder-only arch of the reference (dense, MoE, SSM and
hybrid).  The reference registers ten; an arch whose layer kinds are not
ported yet raises ``NotImplementedError`` naming it, an unknown one
``KeyError``.
"""
from __future__ import annotations

import importlib

from ..models.config import ModelConfig

_ARCH_MODULES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen3-1.7b": "qwen3_1_7b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "rwkv6-7b": "rwkv6_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}

# The reference's other archs: cross-attention and encoder-decoder layers
# wait for later slices.
NOT_PORTED = ("seamless-m4t-large-v2", "llama-3.2-vision-90b")

ARCHS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not yet ported to repro_torch; have {ARCHS}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {ARCHS}")
    mod = importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)
    return mod.CONFIG.validate()
