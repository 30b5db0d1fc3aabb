"""Synthetic data generators of the paper's SS6.2 evaluation matrix (numpy,
the same draws as the reference for the same seed)."""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np

from ..core.sampling import GroupedData

DISTRIBUTIONS: Dict[str, Callable[[np.random.Generator, int], np.ndarray]] = {
    "normal": lambda rng, n: rng.standard_normal(n),
    "exp": lambda rng, n: rng.exponential(1.0, n),
    "uniform": lambda rng, n: rng.uniform(0.0, 1.0, n),
    "pareto1": lambda rng, n: (1.0 + rng.pareto(1.0, n)),
    "pareto2": lambda rng, n: (1.0 + rng.pareto(2.0, n)),
    "pareto3": lambda rng, n: (1.0 + rng.pareto(3.0, n)),
}


def make_grouped(dists: Sequence[str], n_per_group: int, *, seed: int = 0,
                 biases: Sequence[float] | None = None,
                 device=None) -> GroupedData:
    """One group per distribution name (paper SS6.2.2 distribution pairs)."""
    rng = np.random.default_rng(seed)
    groups = []
    for i, d in enumerate(dists):
        x = DISTRIBUTIONS[d](rng, n_per_group).astype(np.float32)
        if biases is not None:
            x = x + biases[i]
        groups.append(x)
    return GroupedData.from_group_arrays(groups, device=device)
