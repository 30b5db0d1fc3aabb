"""Exact answers of the served queries, in float64, from the generated
columns themselves.

The table is made again from the seed, chunk by chunk (``data/lineitem.py``),
so nothing the program holds or derived (its resident copy, offsets, scale,
sample buffers) is read.  Group extents follow from the chunks' group ids.
Imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from ..data import lineitem

SHIFT = 38_000.0        # near the measure's mean: keeps the f64 sums exact


def exact_answers(cfg: dict, seed: int, device, funcs: Iterable[str]
                  ) -> Dict[str, np.ndarray]:
    """``{func: (groups,) float64}`` over the seed's table."""
    m = int(cfg["groups"])
    dev = torch.device(device)
    n = torch.zeros(m, dtype=torch.float64, device=dev)
    s1 = torch.zeros(m, dtype=torch.float64, device=dev)
    s2 = torch.zeros(m, dtype=torch.float64, device=dev)
    for g, _, x in lineitem.chunks(cfg, seed, dev):
        d = x.to(torch.float64) - SHIFT
        n[g] += x.shape[0]
        s1[g] += d.sum()
        s2[g] += (d * d).sum()
    n, s1, s2 = (t.cpu().numpy() for t in (n, s1, s2))
    mean = SHIFT + s1 / n
    var = s2 / n - (s1 / n) ** 2
    table = {"avg": mean, "sum": mean * n, "var": var, "std": np.sqrt(var)}
    return {f: table[f].astype(np.float64) for f in set(funcs)}
