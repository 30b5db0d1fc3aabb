"""Architecture + input-shape registry of the port: ``get_config(arch)``
for the ten archs of the reference -- dense, MoE, SSM, hybrid,
encoder-decoder and vision; an unknown arch raises ``KeyError`` -- and the
reference's four input shapes.  ``long_500k`` applies only to the
sub-quadratic archs (SSM / hybrid / sliding window).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional

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
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
}

# Archs of the reference the port does not register: none is left.
NOT_PORTED = ()

ARCHS = tuple(_ARCH_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# Sub-quadratic attention is required for long_500k.
SUBQUADRATIC = {"rwkv6-7b", "jamba-1.5-large-398b", "h2o-danube-3-4b"}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {ARCHS}")
    mod = importlib.import_module(f".{_ARCH_MODULES[arch]}", __package__)
    return mod.CONFIG.validate()


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


def shape_applicable(arch: str, shape: str) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the skip reason."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return "full quadratic attention at 524k context (per assignment)"
    return None


def list_archs():
    return [(a, get_config(a)) for a in ARCHS]
