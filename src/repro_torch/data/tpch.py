"""Synthetic TPC-H ``lineitem`` for the SS6.3 efficiency benchmarks (numpy,
the same rows as the reference for the same seed).

Scale factor SF gives ~6e6 * SF rows.  Group-by attributes used by the
paper: LINESTATUS (2), RETURNFLAG (3), SHIPINSTRUCT (4), LINENUMBER (7), TAX
(9).  Analytical attribute: EXTENDEDPRICE.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.sampling import GroupedData

GROUP_CARDS = {
    "linestatus": 2,
    "returnflag": 3,
    "shipinstruct": 4,
    "linenumber": 7,
    "tax": 9,
}


def make_lineitem(scale_factor: float = 1.0, group_by: str = "linestatus", *,
                  seed: int = 0, rows: int | None = None,
                  device=None) -> Tuple[GroupedData, np.ndarray]:
    """Returns (grouped data over EXTENDEDPRICE on ``device``, group ids)."""
    if group_by not in GROUP_CARDS:
        raise ValueError(f"unsupported group-by {group_by!r}")
    n = rows if rows is not None else int(6_000_000 * scale_factor)
    rng = np.random.default_rng(seed)
    m = GROUP_CARDS[group_by]
    gid = rng.integers(0, m, size=n)
    # EXTENDEDPRICE = quantity * part price: a right-skewed price column.
    qty = rng.integers(1, 51, size=n).astype(np.float32)
    price = rng.uniform(900.0, 105000.0, size=n).astype(np.float32) / 100.0
    extprice = qty * price
    # Mild per-group shift so GROUP BY answers differ (as in real TPC-H).
    extprice = extprice * (1.0 + 0.01 * gid.astype(np.float32))
    return GroupedData.from_columns(gid, extprice, device=device), gid


def add_group_bias(data: GroupedData, bias: float) -> GroupedData:
    """Separate group means by ``bias`` (relative), as the paper does for the
    ordering experiments (SS6.3.2 'group bias'): group i's values times
    ``(1 + bias) ** i`` in f32, on the data's device."""
    vals = data.values.cpu().numpy().copy()
    for i in range(data.num_groups):
        lo, hi = data.offsets[i], data.offsets[i + 1]
        vals[lo:hi] *= (1.0 + bias) ** i
    return GroupedData(torch.from_numpy(vals), data.offsets.copy(),
                       data.scale.copy(), device=data.device)
