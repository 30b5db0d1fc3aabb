"""Deterministic, stateless token pipeline.

``batch_for_step(step, ...)`` derives every batch purely from the step
counter via the counter PRNG (kernels/prng.py) -- the property the elastic
runbook relies on: a restarted job at step k reproduces batch k exactly,
with no pipeline state to checkpoint (DESIGN.md SS5).

The synthetic corpus is a Zipf-ish unigram stream with a short Markov
flavour (next-token biased toward f(prev)).  The inverse CDF takes an f32
``exp``; it is computed as XLA compiles it for the CPU (``keys.exp_f32``),
so the same code gives the reference's tokens bit for bit on the CPU and on
the card: batch k is a function of k alone across both packages too.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from ..core import keys
from ..core.sampling import default_device
from ..kernels import prng
from ..models.config import ModelConfig

MASK32 = prng.MASK32


def _uniform_extra(seed: int, rows: torch.Tensor, extra_len: int,
                   extra_dim: int) -> torch.Tensor:
    """(B, extra_len, extra_dim) bf16 stub features: one counter uniform
    per (row, position), minus 0.5, repeated over the feature axis."""
    pos = torch.arange(extra_len, dtype=torch.int64, device=rows.device)
    f = prng.uniform01(prng.hash3(seed & MASK32,
                                  (rows * extra_len + pos[None, :]) & MASK32,
                                  0))
    return (f[..., None] - 0.5).expand(-1, -1, extra_dim).to(torch.bfloat16)


def batch_for_step(step: int, *, global_batch: int, seq_len: int, vocab: int,
                   seed: int = 0, extra: Optional[str] = None,
                   extra_len: int = 0, extra_dim: int = 0,
                   device=None) -> Dict[str, torch.Tensor]:
    """Batch ``step``: ``tokens``/``labels`` (B, S) int32 on ``device`` (the
    card by default), plus ``frames`` or ``image_embeds`` (B, extra_len,
    extra_dim) in bf16 when ``extra`` names one."""
    dev = torch.device(device) if device is not None else default_device()
    B, S = global_batch, seq_len
    rows = ((int(step) * B) & MASK32) + torch.arange(
        B, dtype=torch.int64, device=dev)[:, None]
    rows = rows & MASK32
    cols = torch.arange(S + 1, dtype=torch.int64, device=dev)[None, :]
    u = prng.uniform01(prng.hash3(seed & MASK32, rows, cols))
    # Zipf-ish unigram: p(k) ~ 1/(k+1); inverse CDF of that is exp-ish.
    log_v = float(torch.tensor(math.log(float(vocab)), dtype=torch.float32))
    toks = torch.clamp(keys.exp_f32(u * log_v) - 1.0,
                       max=float(vocab - 1)).to(torch.int32)
    # Markov flavour: every 3rd position repeats a hash of the previous.
    prev = torch.roll(toks, 1, dims=1)
    mix = (prng.hash3((seed + 1) & MASK32, rows, cols) % 3) == 0
    toks = torch.where(mix, (prev * 31 + 7) % vocab, toks)
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    if extra == "frames":
        batch["frames"] = _uniform_extra(seed + 2, rows, extra_len, extra_dim)
    elif extra == "image_embeds":
        batch["image_embeds"] = _uniform_extra(seed + 3, rows, extra_len,
                                               extra_dim)
    return batch


def batch_kwargs_for(cfg: ModelConfig, seq_len: int) -> Dict:
    if cfg.is_encdec:
        return dict(extra="frames", extra_len=seq_len, extra_dim=cfg.d_model)
    if cfg.family == "vision":
        return dict(extra="image_embeds", extra_len=cfg.n_frontend_tokens,
                    extra_dim=cfg.d_model)
    return dict(extra=None)


def eval_domains(vocab: int, *, n_domains: int = 3, n_per: int = 512,
                 seq_len: int = 64, seed: int = 100,
                 device=None) -> List[torch.Tensor]:
    """Held-out per-domain eval sets for ``integration.miss_eval``: one
    ``(n_per, seq_len)`` int32 token tensor per domain on ``device``."""
    return [batch_for_step(10_000 + d, global_batch=n_per, seq_len=seq_len,
                           vocab=vocab, seed=seed + d,
                           device=device)["tokens"]
            for d in range(n_domains)]
