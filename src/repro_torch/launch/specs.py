"""Abstract input specs for every (arch x shape) cell of the registry.

No memory is allocated: each spec is a tensor on the ``meta`` device, which
carries a shape and a dtype only (the reference builds
``jax.ShapeDtypeStruct`` trees).  ``input_specs(arch, shape)`` returns the
abstract batch or decode inputs of that cell's step.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs import get_config, get_shape
from ..configs.registry import shape_applicable
from ..models import model as M
from ..models.config import ModelConfig

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, *, seq_len: int, global_batch: int,
                with_labels: bool = True) -> Dict[str, Any]:
    B, S = global_batch, seq_len
    batch: Dict[str, Any] = {"tokens": _spec((B, S), torch.int32)}
    if with_labels:
        batch["labels"] = _spec((B, S), torch.int32)
    if cfg.is_encdec:
        # Audio stub: precomputed frame embeddings at d_model width.
        batch["frames"] = _spec((B, S, cfg.d_model), torch.bfloat16)
    if cfg.family == "vision":
        batch["image_embeds"] = _spec(
            (B, cfg.n_frontend_tokens, cfg.d_model), torch.bfloat16)
    return batch


def cache_specs(cfg: ModelConfig, *, global_batch: int, kv_len: int):
    """Abstract decode caches with the KV buffer sized to kv_len."""
    return M.init_caches(cfg, global_batch, S_max=kv_len,
                         mem_len=(kv_len if cfg.is_encdec
                                  else cfg.n_frontend_tokens or None),
                         length=kv_len - 1, device=META)


def decode_token_spec(cfg: ModelConfig, global_batch: int) -> torch.Tensor:
    return _spec((global_batch, 1), torch.int32)


def input_specs(arch: str, shape_name: str) -> Tuple[str, Dict[str, Any]]:
    """Returns (kind, abstract inputs dict) for the cell.

    kind "train":   {"batch": ...}                 the train step's input
    kind "prefill": {"batch": ...}                 prefill's input
    kind "decode":  {"token": ..., "caches": ...}  a decode step's input
    """
    cfg = get_config(arch)
    shp = get_shape(shape_name)
    skip = shape_applicable(arch, shape_name)
    if skip:
        raise ValueError(f"{arch} x {shape_name} skipped: {skip}")
    if shp.kind == "train":
        return "train", {"batch": batch_specs(
            cfg, seq_len=shp.seq_len, global_batch=shp.global_batch)}
    if shp.kind == "prefill":
        return "prefill", {"batch": batch_specs(
            cfg, seq_len=shp.seq_len, global_batch=shp.global_batch,
            with_labels=False)}
    # decode: one new token against a kv_len cache.
    return "decode", {
        "token": decode_token_spec(cfg, shp.global_batch),
        "caches": cache_specs(cfg, global_batch=shp.global_batch,
                              kv_len=shp.seq_len),
    }
