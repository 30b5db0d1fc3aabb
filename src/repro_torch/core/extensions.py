"""Metric extensions of L2Miss (paper SS5): MaxMiss, LpMiss, OrderMiss,
DiffMiss, and NormalMiss (SS6.2).

Each extension converts a user bound in metric d' to an equivalent L2 bound
eps' with R subset R' (Lemma 9), then runs L2Miss (Algorithm 4):

  MaxMiss  (L-inf, Thm 10):   Gamma(eps) = eps
  LpMiss   (p > 2):           Gamma(eps) = eps           (||.||_2 >= ||.||_p)
  LpMiss   (p = 1):           Gamma(eps) = eps / sqrt(m) (||.||_1 <= sqrt(m)||.||_2)
  OrderMiss (Thm 11/12):      Gamma = min adjacent gap of theta-hat / sqrt(2)
                              via OrderBound (Alg. 5, O(m log m))
  DiffMiss (Thm 13):          Gamma(eps) = eps / sqrt(2)
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import keys as keylib
from . import sampling
from .estimators import Estimator, get as get_estimator
from .framework import MissTrace
from .l2miss import MissConfig, run_l2miss
from .sampling import GroupedData, root_key


# ---------------------------------------------------------------------------
# OrderBound (Algorithm 5)
# ---------------------------------------------------------------------------

def order_bound(theta_hat: torch.Tensor) -> torch.Tensor:
    """eps' = min adjacent gap of sorted(theta) / sqrt(2)   [Thm 12]: the
    min over all pairs of the point-to-hyperplane distances rho_ij =
    |theta_i - theta_j| / sqrt(2), in O(m log m)."""
    t = torch.sort(torch.ravel(theta_hat)).values
    return torch.min(t[1:] - t[:-1]) / float(np.float32(np.sqrt(2.0)))


def order_bound_bruteforce(theta_hat: np.ndarray) -> float:
    """O(m^2) reference (the 'naive algorithm' of SS5.3)."""
    t = np.ravel(np.asarray(theta_hat))
    m = len(t)
    best = np.inf
    for i in range(m):
        for j in range(i + 1, m):
            best = min(best, abs(t[i] - t[j]) / np.sqrt(2.0))
    return float(best)


# ---------------------------------------------------------------------------
# Conversion functions Gamma
# ---------------------------------------------------------------------------

def gamma_linf(eps: float, m: int) -> float:
    return eps                       # Thm 10


def gamma_lp(eps: float, m: int, p: float) -> float:
    if p == 1:
        return eps / float(np.sqrt(m))
    if p >= 2:
        return eps
    raise ValueError("L^p conversion defined for p = 1 or p >= 2")


def gamma_diff(eps: float, m: int) -> float:
    return eps / float(np.sqrt(2.0))  # Thm 13


# ---------------------------------------------------------------------------
# Extension runs (Algorithm 4)
# ---------------------------------------------------------------------------

def run_maxmiss(data: GroupedData, estimator, cfg: MissConfig,
                store=None) -> MissTrace:
    cfg2 = dataclasses.replace(
        cfg, epsilon=gamma_linf(cfg.epsilon, data.num_groups))
    return run_l2miss(data, estimator, cfg2, store=store)


def run_lpmiss(data: GroupedData, estimator, cfg: MissConfig, p: float,
               store=None) -> MissTrace:
    cfg2 = dataclasses.replace(
        cfg, epsilon=gamma_lp(cfg.epsilon, data.num_groups, p))
    return run_l2miss(data, estimator, cfg2, store=store)


def run_diffmiss(data: GroupedData, estimator, cfg: MissConfig,
                 store=None) -> MissTrace:
    cfg2 = dataclasses.replace(
        cfg, epsilon=gamma_diff(cfg.epsilon, data.num_groups))
    return run_l2miss(data, estimator, cfg2, store=store)


def run_normalmiss(data: GroupedData, estimator, cfg: MissConfig,
                   store=None) -> MissTrace:
    """NormalMiss (paper SS6.2): L2Miss with the CLT Gaussian-replicate
    ESTIMATE instead of the bootstrap."""
    cfg2 = dataclasses.replace(cfg, backend="normal")
    return run_l2miss(data, estimator, cfg2, store=store)


def _group_thetas(est: Estimator, sample: torch.Tensor,
                  mask: torch.Tensor) -> np.ndarray:
    """(m, p) plain estimate of every group of a masked sample."""
    return torch.stack([est.apply(est.prepare(xg), mg)
                        for xg, mg in zip(sample, mask)]).cpu().numpy()


def run_ordermiss(
    data: GroupedData,
    estimator,
    cfg: MissConfig,
    *,
    pilot_n: int = 2000,
    pilot_repeats: int = 4,
    seed: Optional[int] = None,
    store=None,
) -> MissTrace:
    """OrderMiss (SS5.3): the bound depends on theta-hat, so a pilot
    estimate (averaged over a few samples) feeds OrderBound for eps', then
    L2Miss runs.  With a store, repeat r reads the disjoint window [r n, (r
    + 1) n) of its permutation, a prefix the L2Miss run then re-reads."""
    est: Estimator = (
        get_estimator(estimator) if isinstance(estimator, str) else estimator
    )
    key = root_key(cfg.seed if seed is None else seed)
    m = data.num_groups
    thetas = []
    if store is not None:
        n_pilot = np.minimum(pilot_n, data.sizes)
        for r in range(pilot_repeats):
            sample, mask = store.sample(n_pilot, base=r * n_pilot)
            thetas.append(_group_thetas(est, sample, mask))
    else:
        n_vec = np.minimum(np.full((m,), pilot_n), data.sizes)
        for _ in range(pilot_repeats):
            key, sub = keylib.split(key, 2)
            sample, mask = sampling.stratified_sample(
                sub, data.values, data.offsets, n_vec,
                sampling.bucket_cap(pilot_n))
            thetas.append(_group_thetas(est, sample, mask))
    theta_bar = np.mean(np.stack(thetas), axis=0)
    scale = data.scale if est.needs_population_scale else np.ones((m,))
    eps_prime = float(order_bound(torch.as_tensor(
        np.asarray(theta_bar[:, 0] * scale, np.float32))))
    cfg2 = dataclasses.replace(cfg, epsilon=max(eps_prime, 1e-12))
    trace = run_l2miss(data, est, cfg2, store=store)
    trace.info["order_bound_eps"] = eps_prime
    trace.info["pilot_theta"] = theta_bar
    return trace


# ---------------------------------------------------------------------------
# Metric evaluation (tests, the serve phase's accuracy count)
# ---------------------------------------------------------------------------

def metric_value(name: str, theta_hat: np.ndarray, theta: np.ndarray) -> float:
    th, t = np.ravel(theta_hat), np.ravel(theta)
    d = th - t
    if name == "l2":
        return float(np.sqrt(np.sum(d**2)))
    if name == "linf":
        return float(np.max(np.abs(d)))
    if name == "l1":
        return float(np.sum(np.abs(d)))
    if name == "diff":
        # max_{i,j} |(th_i - th_j) - (t_i - t_j)|  (Def. 4) = max d - min d
        return float(np.max(d) - np.min(d))
    if name == "order":
        return 0.0 if bool(np.all(np.argsort(th) == np.argsort(t))) else 1.0
    raise ValueError(f"unknown metric {name!r}")
