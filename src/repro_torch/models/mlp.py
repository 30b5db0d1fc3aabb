"""Feed-forward block: the dense SwiGLU MLP.  The reference's MoE block is
not ported yet (a MoE layer kind raises in ``models.model``)."""
from __future__ import annotations

import torch

from . import nn


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, dtype,
             device):
    return {
        "wi_gate": nn.dense_init(generator, d_model, d_ff, dtype, device),
        "wi_up": nn.dense_init(generator, d_model, d_ff, dtype, device),
        "wo": nn.dense_init(generator, d_ff, d_model, dtype, device,
                            scale=d_ff ** -0.5),
    }


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(nn.dense(p["wi_gate"], x)) * nn.dense(
        p["wi_up"], x)
    return nn.dense(p["wo"], h)
