"""Analytical functions (the ``f`` in ``SELECT X, f(Y)``) of the moment family.

Every estimator here has a *moments finish*: a replicate's value is a cheap
function of its weighted moment sums ``M_b = [sum w, sum w x, sum w x^2]``,
so all B bootstrap replicates come from one masked moment contraction (the
Poisson-bootstrap kernel) and the estimators differ only in the finish.

Ids are assigned in registration order and are part of the serialized
trajectory contract shared with the reference: the moment family holds ids
0-5 and a lane's ``est_fids`` entry is its index in :func:`moment_family`.
New estimators (quantiles, min/max, regressions) are only ever APPENDED.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Estimator:
    """A weighted analytical function with a moments fast path.

    ``moments_finish`` maps ``(..., 3)`` moment sums to ``(..., 1)`` values;
    ``needs_population_scale`` marks SUM/COUNT, whose answer is ``|D|_i``
    times the consistent estimator (paper SS2.2.1); ``eid`` is the stable
    registration id.
    """

    name: str
    moments_finish: Callable[[torch.Tensor], torch.Tensor]
    out_dim: Callable[[int], int] = lambda c: 1
    needs_population_scale: bool = False
    eid: int = -1


REGISTRY: Dict[str, Estimator] = {}
REGISTRY_BY_ID: List[Estimator] = []


def register(est: Estimator) -> Estimator:
    """Register (or re-register in place) an estimator, keeping
    ``REGISTRY_BY_ID[i].eid == i``."""
    prev = REGISTRY.get(est.name)
    if prev is not None:
        est = dataclasses.replace(est, eid=prev.eid)
        REGISTRY_BY_ID[prev.eid] = est
    else:
        est = dataclasses.replace(est, eid=len(REGISTRY_BY_ID))
        REGISTRY_BY_ID.append(est)
    REGISTRY[est.name] = est
    return est


def get(name: str) -> Estimator:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown estimator {name!r}; have {sorted(REGISTRY)}")


def est_id(name: str) -> int:
    return get(name).eid


def moment_family() -> Tuple[Estimator, ...]:
    """The moments-fast-path estimators, ordered by ``eid``; a lane's
    family index is its position here."""
    return tuple(e for e in REGISTRY_BY_ID if e.moments_finish is not None)


def moment_family_index(name: str) -> int:
    """Family (branch) index of a moment estimator; raises for others."""
    est = get(name)
    fam = moment_family()
    for i, e in enumerate(fam):
        if e.eid == est.eid:
            return i
    raise ValueError(
        f"estimator {name!r} has no moments fast path; heterogeneous lanes "
        f"support {[e.name for e in fam]}")


def population_scale_row(name: str, data_scale) -> np.ndarray:
    """(m,) per-group scale row: ``|D|_i`` for SUM/COUNT, ones otherwise."""
    scale = np.asarray(data_scale, np.float32)
    if get(name).needs_population_scale:
        return scale
    return np.ones_like(scale)


def _mean_finish(M: torch.Tensor) -> torch.Tensor:
    return M[..., 1:2] / torch.clamp(M[..., 0:1], min=_EPS)


def _var_finish(M: torch.Tensor) -> torch.Tensor:
    mu = M[..., 1] / torch.clamp(M[..., 0], min=_EPS)
    return (M[..., 2] / torch.clamp(M[..., 0], min=_EPS) - mu * mu)[..., None]


def _std_finish(M: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(_var_finish(M), min=0.0))


register(Estimator("avg", _mean_finish))
register(Estimator("proportion", _mean_finish))
register(Estimator("var", _var_finish))
register(Estimator("std", _std_finish))
# SUM(Y) = |D| * AVG(Y); COUNT(pred) = |D| * PROPORTION(pred)  (paper SS2.2.1)
register(Estimator("sum", _mean_finish, needs_population_scale=True))
register(Estimator("count", _mean_finish, needs_population_scale=True))


def finish_by_family(fids: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Per-lane finish: lane i of ``M (q, ..., 3)`` through family branch
    ``fids[i]``.  Every branch is computed and one is selected, so the chosen
    values are bitwise those of the homogeneous finish."""
    fam = moment_family()
    out = torch.zeros(M.shape[:-1] + (1,), dtype=M.dtype, device=M.device)
    sel = fids.reshape((-1,) + (1,) * (M.dim() - 1))
    for i, e in enumerate(fam):
        out = torch.where(sel == i, e.moments_finish(M), out)
    return out
