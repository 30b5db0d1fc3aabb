"""AdamW optimizer + LR schedule (the reference's ``train/optimizer.py``).

Supports reduced-precision moments (``moment_dtype="bfloat16"``) and
optional f32 master copies of the params (``master_fp32``).  The moment
and param arithmetic runs in f32 whatever the storage dtype; each param is
cast back to its own dtype.  ``step`` is an int32 tensor on the params'
device, and the learning rate and bias corrections are f32 tensors
computed there, so an update reads nothing back to the host.  The update
runs leaf by leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from . import pytree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 2_000
    total_steps: int = 100_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"        # "float32" | "bfloat16"
    master_fp32: bool = False            # keep fp32 master copies


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to lr_min_ratio * peak (f32)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps,
                                        1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr_peak * torch.where(step < cfg.warmup_steps, warm, cos)


def _clip(flat, max_norm: float):
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in flat))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return [(g.float() * scale).to(g.dtype) for g in flat], gnorm


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before clipping).  Squares are summed in f32 in ``pytree`` order."""
    flat, skel = pytree.flatten(grads)
    out, gnorm = _clip(flat, max_norm)
    return pytree.unflatten(skel, out), gnorm


def _mdt(cfg: AdamWConfig):
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32


def adamw_init(cfg: AdamWConfig, params) -> Dict[str, Any]:
    mdt = _mdt(cfg)
    first = pytree.leaves(params)[0]
    state = {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "mu": pytree.tree_map(lambda p: torch.zeros_like(p, dtype=mdt),
                              params),
        "nu": pytree.tree_map(lambda p: torch.zeros_like(p, dtype=mdt),
                              params),
    }
    if cfg.master_fp32:
        state["master"] = pytree.tree_map(lambda p: p.float(), params)
    return state


def adamw_update(cfg: AdamWConfig, grads, state: Dict[str, Any], params
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (new params, new state, {lr, grad_norm, step})."""
    flat_g, skel = pytree.flatten(grads)
    flat_g, gnorm = _clip(flat_g, cfg.grad_clip)
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    mdt = _mdt(cfg)
    flat_m = pytree.leaves(state["mu"])
    flat_v = pytree.leaves(state["nu"])
    flat_p = pytree.leaves(params)
    flat_base = pytree.leaves(state.get("master", params))
    if not len(flat_g) == len(flat_m) == len(flat_v) == len(flat_p):
        raise ValueError("grads, moments and params differ in structure")
    new_m, new_v, new_master, new_p = [], [], [], []
    for g, m, v, base, p in zip(flat_g, flat_m, flat_v, flat_base, flat_p):
        gf = g.float()
        m32 = b1 * m.float() + (1 - b1) * gf
        v32 = b2 * v.float() + (1 - b2) * gf * gf
        mhat = m32 / bc1
        vhat = v32 / bc2
        pf = base.float()
        pf = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                        + cfg.weight_decay * pf)
        new_m.append(m32.to(mdt))
        new_v.append(v32.to(mdt))
        new_master.append(pf)
        new_p.append(pf.to(p.dtype))
    new_state = {"step": step, "mu": pytree.unflatten(skel, new_m),
                 "nu": pytree.unflatten(skel, new_v)}
    if cfg.master_fp32:
        new_state["master"] = pytree.unflatten(skel, new_master)
    metrics = {"lr": lr, "grad_norm": gnorm, "step": step}
    return pytree.unflatten(skel, new_p), new_state, metrics
