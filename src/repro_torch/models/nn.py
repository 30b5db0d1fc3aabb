"""Functional NN primitives over plain tensors.

Parameters are dicts of tensors; layers are functions ``apply(params, x)``.
Matmul-bearing ops keep the parameter dtype (bf16 at scale);
normalisation and softmax run in f32.  Weights keep the reference's
``(d_in, d_out)`` layout, so converted parameters need no transpose.
"""
from __future__ import annotations

from typing import Optional

import torch


def _trunc_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                       generator=generator)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               device, scale: Optional[float] = None,
               stack: Optional[int] = None) -> torch.Tensor:
    """Truncated normal on [-2, 2] times ``scale`` (default ``d_in**-0.5``),
    drawn in f32 on ``device`` from ``generator`` (which lives there);
    ``stack`` experts' matrices stacked on a leading axis."""
    if scale is None:
        scale = d_in ** -0.5
    shape = (d_in, d_out) if stack is None else (stack, d_in, d_out)
    return (_trunc_normal(shape, generator, device) * scale).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    return _trunc_normal((vocab, d), generator, device).to(dtype)


def dense(w: torch.Tensor, x: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = torch.matmul(x, w)
    if bias is not None:
        y = y + bias
    return y


def rms_norm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32, cast back to ``x``'s dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * g.float()).to(x.dtype)


def rms_norm_init(d: int, device) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


def rope_angles(positions: torch.Tensor, d_head: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., d_head/2) cos/sin tables for the given positions."""
    half = d_head // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, d_head); cos/sin (..., S, half) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross entropy over valid positions; logits f32 upcast."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
