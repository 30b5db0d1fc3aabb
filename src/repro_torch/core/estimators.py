"""Analytical functions (the ``f`` in ``SELECT X, f(Y)``) as weighted
estimators.

Every estimator implements a *weighted* evaluation ``apply(aux, w)``: ``w``
is a non-negative per-row weight vector ``(..., n)`` with any leading batch
dims, so one call serves plain evaluation (``w = mask``), all B bootstrap
replicates at once (``w = mask * Poisson(1)`` counts, ``(B, n)``) and
predicate queries (the predicate folded into an indicator column).  The
O(n log n) work (sorting for quantiles, the design matrix of regressions)
sits in ``prepare(x) -> aux`` and runs once.

The moment family (avg/proportion/var/std/sum/count) also has a *moments
finish*: a replicate's value is a cheap function of its weighted moment
sums ``M_b = [sum w, sum w x, sum w x^2]``, so all B replicates come from
one masked moment contraction (the Poisson-bootstrap kernel) and the
estimators differ only in the finish.

Ids are assigned in registration order and are part of the serialized
trajectory contract shared with the reference: the moment family holds ids
0-5 and a lane's ``est_fids`` entry is its index in :func:`moment_family`.
New estimators are only ever APPENDED.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class Estimator:
    """A weighted analytical function.

    ``prepare`` maps the sample ``x (n, c)`` to ``aux``; ``apply(aux, w
    (..., n)) -> (..., p)`` must tolerate zero weights; ``out_dim`` maps the
    column count to ``p``.  ``moments_finish`` maps ``(..., 3)`` moment sums
    to ``(..., 1)`` values (moment family only); ``needs_population_scale``
    marks SUM/COUNT, whose answer is ``|D|_i`` times the consistent
    estimator (paper SS2.2.1); ``bootstrap_consistent`` is False for the
    true extrema; ``eid`` is the stable registration id.
    """

    name: str
    prepare: Callable[[torch.Tensor], Any]
    apply: Callable[[Any, torch.Tensor], torch.Tensor]
    out_dim: Callable[[int], int] = lambda c: 1
    bootstrap_consistent: bool = True
    needs_population_scale: bool = False
    moments_finish: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
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


def get_by_id(eid: int) -> Estimator:
    try:
        return REGISTRY_BY_ID[eid]
    except IndexError:
        raise KeyError(f"unknown estimator id {eid}; have "
                       f"0..{len(REGISTRY_BY_ID) - 1}")


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


# ---------------------------------------------------------------------------
# Scalar moment estimators
# ---------------------------------------------------------------------------

def _col0(x: torch.Tensor) -> torch.Tensor:
    return x[:, 0] if x.dim() == 2 else x


def _wmean(v: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.sum(w * v, -1) / torch.clamp(torch.sum(w, -1), min=_EPS)


def _avg_apply(aux: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _wmean(aux, w)[..., None]


def _var_apply(aux: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    m = _wmean(aux, w)
    d = aux - m[..., None]
    return _wmean(d * d, w)[..., None]


def _std_apply(aux: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_var_apply(aux, w))


def _mean_finish(M: torch.Tensor) -> torch.Tensor:
    return M[..., 1:2] / torch.clamp(M[..., 0:1], min=_EPS)


def _var_finish(M: torch.Tensor) -> torch.Tensor:
    mu = M[..., 1] / torch.clamp(M[..., 0], min=_EPS)
    return (M[..., 2] / torch.clamp(M[..., 0], min=_EPS) - mu * mu)[..., None]


def _std_finish(M: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(_var_finish(M), min=0.0))


def _moment(name: str, apply, finish, scale: bool = False) -> Estimator:
    return Estimator(name, _col0, apply, needs_population_scale=scale,
                     moments_finish=finish)


register(_moment("avg", _avg_apply, _mean_finish))
register(_moment("proportion", _avg_apply, _mean_finish))
register(_moment("var", _var_apply, _var_finish))
register(_moment("std", _std_apply, _std_finish))
# SUM(Y) = |D| * AVG(Y); COUNT(pred) = |D| * PROPORTION(pred)  (paper SS2.2.1)
register(_moment("sum", _avg_apply, _mean_finish, scale=True))
register(_moment("count", _avg_apply, _mean_finish, scale=True))


# ---------------------------------------------------------------------------
# Order statistics: QUANTILE / MEDIAN / MIN / MAX
# ---------------------------------------------------------------------------
# Weighted quantile on pre-sorted values: a replicate's value is the value at
# the first index where the (permuted) cumulative weight reaches q * total.
# The sort is stable, as jnp.argsort's, so ties order as in the reference;
# the cumulative weights are integer-valued f32 sums (exact below 2**24), so
# replicates equal the reference's bit for bit.

def _sorted_prepare(x: torch.Tensor):
    v = _col0(x)
    order = torch.argsort(v, stable=True)
    return v[order], order


def _quantile_apply(q: float, aux, w: torch.Tensor) -> torch.Tensor:
    v_sorted, order = aux
    cw = torch.cumsum(w[..., order], -1)
    total = torch.clamp(cw[..., -1:], min=_EPS)
    # Right-continuous generalized inverse CDF.
    idx = torch.searchsorted(cw.contiguous(), (q * total).contiguous(),
                             right=False)
    idx = torch.clamp(idx, 0, v_sorted.shape[0] - 1)
    return v_sorted[idx]


def make_quantile(q: float, name: Optional[str] = None) -> Estimator:
    return Estimator(name or f"quantile_{q:g}", _sorted_prepare,
                     partial(_quantile_apply, q))


register(make_quantile(0.5, "median"))
# Paper SS4.2: MIN/MAX are approximated by alpha / 1-alpha quantiles so that
# the bootstrap stays consistent.
register(make_quantile(0.99, "maxq"))
register(make_quantile(0.01, "minq"))


def _max_apply(aux: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # True sample extremum of the resample (bootstrap-INconsistent; kept to
    # reproduce the paper's negative cases).
    return torch.amax(torch.where(w > 0, aux, -torch.inf), -1)[..., None]


def _min_apply(aux: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.amin(torch.where(w > 0, aux, torch.inf), -1)[..., None]


register(Estimator("max", _col0, _max_apply, bootstrap_consistent=False))
register(Estimator("min", _col0, _min_apply, bootstrap_consistent=False))


# ---------------------------------------------------------------------------
# M-estimators: LINREG / LOGREG
# ---------------------------------------------------------------------------
# x has c columns: features x[:, :-1], target x[:, -1]; an intercept column
# is prepended, so the output has max(c, 2) coefficients.

_RIDGE = 1e-6


def _design(x: torch.Tensor):
    if x.dim() == 1:
        x = x[:, None]
    feats, y = x[:, :-1], x[:, -1]
    ones = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
    return torch.cat([ones, feats], dim=1), y


def _ridge(p: int, X: torch.Tensor) -> torch.Tensor:
    return _RIDGE * torch.eye(p, dtype=X.dtype, device=X.device)


def _linreg_apply(aux, w: torch.Tensor) -> torch.Tensor:
    X, y = aux
    Xw = X * w[..., :, None]                                   # (..., n, p)
    G = X.T @ Xw + _ridge(X.shape[1], X)
    b = (Xw.transpose(-1, -2) @ y[:, None])[..., 0]
    return torch.linalg.solve(G, b)


register(Estimator("linreg", _design, _linreg_apply, lambda c: max(c, 2)))


def _logreg_apply(aux, w: torch.Tensor, newton_iters: int = 12
                  ) -> torch.Tensor:
    X, y = aux
    p_dim = X.shape[1]
    theta = torch.zeros(w.shape[:-1] + (p_dim,), dtype=X.dtype,
                        device=X.device)
    Xw_t = (X * w[..., :, None]).transpose(-1, -2)             # (..., p, n)
    for _ in range(newton_iters):
        p = torch.sigmoid((X @ theta[..., None])[..., 0])      # (..., n)
        s = torch.clamp(p * (1.0 - p), min=1e-6) * w
        G = (X * s[..., :, None]).transpose(-1, -2) @ X + _ridge(p_dim, X)
        g = (Xw_t @ (p - y)[..., None])[..., 0]
        theta = theta - torch.linalg.solve(G, g)
    return theta


register(Estimator("logreg", _design, _logreg_apply, lambda c: max(c, 2)))


# ---------------------------------------------------------------------------
# Plain (unweighted) evaluation
# ---------------------------------------------------------------------------

def evaluate(est: Estimator, x: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """theta-hat = f(S): weighted apply with unit weights (times mask)."""
    n = x.shape[0]
    w = (torch.ones((n,), dtype=torch.float32, device=x.device)
         if mask is None else mask.to(torch.float32))
    return est.apply(est.prepare(x), w)


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
