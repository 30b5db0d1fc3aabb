"""The control: the plain reference put in the program's place, one binary
digit less precise than the configuration states.

Each request is answered by plain uniform sampling with replacement from the
seed's table and a plain bootstrap (``B`` multinomial resamples) of the L2
error: a pilot of ``n_min`` rows a group, then the size at which the
(1 - delta) quantile of the bootstrap error, falling as 1/sqrt(n), meets
TWICE the request's bound, checked again at that size.  Judged against the
stated bound by ``judge.py``, it has to come out as not correct.  Imports
nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

WIDEN = 2.0


def _estimate(func: str, x: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """Per-row estimates over the last axis of ``x`` (float64)."""
    mean = x.mean(-1)
    if func == "avg":
        return mean
    if func == "sum":
        return mean * size.reshape(size.shape + (1,) * (mean.dim() - 1))
    var = (x * x).mean(-1) - mean * mean
    if func == "var":
        return var
    if func == "std":
        return torch.sqrt(torch.clamp(var, min=0.0))
    raise ValueError(f"no control for func {func!r}")


def _answer(values, lo, size, spec, gen, B, n_min, n_cap, widen):
    """theta (g,) of the groups at ``lo``/``size``, answered jointly."""
    dev = values.device
    sizef = size.to(torch.float64)
    func, eps = spec["func"], float(spec["epsilon"])
    delta = float(spec.get("delta", 0.05))
    n = int(n_min)
    while True:
        u = torch.rand((lo.shape[0], n), generator=gen, device=dev,
                       dtype=torch.float64)
        x = values[lo[:, None] + (u * sizef[:, None]).long()]
        x = x.to(torch.float64)
        theta = _estimate(func, x, sizef)                       # (g,)
        pick = torch.randint(0, n, (B, n), generator=gen, device=dev)
        b = _estimate(func, x[:, pick], sizef) - theta[:, None]  # (g, B)
        err = float(torch.quantile(torch.linalg.norm(b, dim=0), 1.0 - delta))
        if err <= widen * eps or n >= n_cap:
            return theta.cpu().numpy()
        # The error falls as 1/sqrt(n): the size that meets the bound.
        n = min(max(int(np.ceil(n * (err / (widen * eps)) ** 2)), n + 1),
                int(n_cap))


def control_answer(values: torch.Tensor, offsets: np.ndarray, spec: dict,
                   gen: torch.Generator, *, B: int, n_min: int, n_cap: int,
                   widen: float = WIDEN) -> dict:
    """``{"theta": (groups,), "success": True}`` for one request; a GROUP
    BY request sizes each group on its own."""
    dev = values.device
    lo = torch.as_tensor(offsets[:-1], device=dev)
    size = torch.as_tensor(np.diff(offsets), device=dev)
    kw = dict(gen=gen, B=B, n_min=n_min, n_cap=n_cap, widen=widen)
    if not spec.get("group_by"):
        return {"theta": _answer(values, lo, size, spec, **kw),
                "success": True}
    theta = np.concatenate([_answer(values, lo[g:g + 1], size[g:g + 1],
                                    spec, **kw)
                            for g in range(lo.shape[0])])
    return {"theta": theta, "success": True}
