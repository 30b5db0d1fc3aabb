"""Synthetic data generators of the paper's SS6.2 evaluation matrix (numpy,
the same draws as the reference for the same seed), put on the caller's
device (the card by default).

Pareto1 has infinite mean-variance; Pareto2 infinite variance -- the cases
where the bootstrap is theoretically inconsistent.  Regression cases
generate (features..., target) columns for LINREG/LOGREG.
"""
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

# Cases where Lemma 3 (bootstrap consistency) fails (paper SS6.2): heavy tails
# with infinite variance, and the MAX/MIN extremes.
INCONSISTENT_DISTS = {"pareto1", "pareto2"}
INCONSISTENT_FUNCS = {"max", "min"}


def make_single_group(dist: str, n: int, *, seed: int = 0, bias: float = 0.0,
                      device=None) -> GroupedData:
    rng = np.random.default_rng(seed)
    x = DISTRIBUTIONS[dist](rng, n).astype(np.float32) + bias
    return GroupedData.from_group_arrays([x], device=device)


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


def make_regression(n: int, d: int = 3, *, noise: float = 0.5, seed: int = 0,
                    logistic: bool = False, groups: int = 1,
                    device=None) -> GroupedData:
    """(features, target) columns for LINREG / LOGREG cases."""
    rng = np.random.default_rng(seed)
    beta = rng.uniform(-1.0, 1.0, size=(d + 1,))
    out = []
    for _ in range(groups):
        X = rng.standard_normal((n, d))
        eta = beta[0] + X @ beta[1:]
        if logistic:
            p = 1.0 / (1.0 + np.exp(-eta))
            y = (rng.uniform(size=n) < p).astype(np.float64)
        else:
            y = eta + noise * rng.standard_normal(n)
        out.append(np.concatenate([X, y[:, None]], axis=1).astype(np.float32))
    return GroupedData.from_group_arrays(out, device=device)
