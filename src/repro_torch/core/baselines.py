"""Baseline SSO / AQP algorithms the paper compares against (SS6.3):

  BLK       BlinkDB-style closed-form sample sizing from the CLT/normality
            assumption [Agarwal+ 13].  Near-oracle when it applies (AVG-like
            aggregates) -- the paper's "best method as long as it can be
            applied".
  SPS       Sample+Seek [Ding+ 16]: measure-biased sampling with a
            Chernoff-type distribution-precision bound; needs a full scan.
  IFOCUS    IFocus [Kim+ 15]: incremental sampling with Hoeffding CIs,
            ordering guarantees.
  MINIBATCH iOLAP-style model-free searcher: grow the sample a step at a
            time until the bootstrap error meets the bound.

All return a ``BaselineResult`` with the same cost accounting as MissTrace.

The table stays on its device.  The host-numpy parts (the pilot
statistics, the IFocus rounds, SPS's measure-biased draw) draw their row
indices from numpy's generator on the host, as the reference does, gather
those rows on the device and copy only them back, so their answers equal
the reference's bit for bit.  SPS alone copies the whole column to the
host: its full scan is its defined cost.  BLK's final sample and the
MiniBatch searcher run on the device (``stratified_sample``, the generic
bootstrap).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from . import bootstrap as B_
from . import keys as keylib
from . import sampling as S
from .estimators import get as get_estimator
from .sampling import GroupedData


@dataclasses.dataclass
class BaselineResult:
    name: str
    success: bool
    n: np.ndarray
    theta: Optional[np.ndarray]
    total_sampled: int          # rows touched incl. scans/pilots (cost proxy)
    iterations: int
    wall_time_s: float
    info: dict


def _norm_ppf(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation);
    |err| < 1.2e-8 over (0,1)."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00]
    p_low, p_high = 0.02425, 1 - 0.02425
    if p < p_low:
        q = np.sqrt(-2 * np.log(p))
        return (((((c[0]*q+c[1])*q+c[2])*q+c[3])*q+c[4])*q+c[5]) / \
               ((((d[0]*q+d[1])*q+d[2])*q+d[3])*q+1)
    if p <= p_high:
        q = p - 0.5
        r = q * q
        return (((((a[0]*r+a[1])*r+a[2])*r+a[3])*r+a[4])*r+a[5])*q / \
               (((((b[0]*r+b[1])*r+b[2])*r+b[3])*r+b[4])*r+1)
    q = np.sqrt(-2 * np.log(1 - p))
    return -(((((c[0]*q+c[1])*q+c[2])*q+c[3])*q+c[4])*q+c[5]) / \
           ((((d[0]*q+d[1])*q+d[2])*q+d[3])*q+1)


def _gather_host(data: GroupedData, idx: List[np.ndarray]) -> List[np.ndarray]:
    """Column 0 of the rows ``idx[i]`` (host int64 row numbers), gathered
    on the data's device in one indexing and copied to the host: f32 arrays,
    one per entry of ``idx``."""
    if not idx:
        return []
    flat = np.concatenate(idx)
    rows = torch.as_tensor(flat, device=data.device)
    x = data.values[rows, 0].cpu().numpy()
    return [np.array(part) for part in
            np.split(x, np.cumsum([len(i) for i in idx])[:-1])]


def _group_pilot_stats(data: GroupedData, rng, pilot_n: int):
    """Per-group pilot mean/var/range/4th-moment from a small uniform sample."""
    m = data.num_groups
    stats = np.zeros((m, 5))
    idx = []
    for i in range(m):
        lo, hi = data.offsets[i], data.offsets[i + 1]
        idx.append(rng.integers(lo, hi, size=min(pilot_n, hi - lo)))
    for i, x in enumerate(_gather_host(data, idx)):
        mu = x.mean()
        var = x.var()
        mu4 = np.mean((x - mu) ** 4)
        stats[i] = (mu, var, x.max() - x.min(), mu4, len(x))
    return stats


def run_blk(
    data: GroupedData, estimator: str, epsilon: float, delta: float,
    *, pilot_n: int = 1000, seed: int = 0,
) -> BaselineResult:
    """BlinkDB-style closed form, equal error split across groups (SS6.3.1).

    Per group: eps_i = eps / sqrt(m) at confidence 1 - delta/m (Bonferroni),
    n_i = (z * sigma_i / eps_i)^2.  Supports avg/sum/count/var (CLT cases).
    The final answer comes from a stratified sample of the computed sizes
    on the data's device, one batched ``apply`` over the groups.
    """
    t0 = time.perf_counter()
    est = get_estimator(estimator)
    if estimator not in ("avg", "sum", "count", "proportion", "var"):
        return BaselineResult("BLK", False, np.zeros(data.num_groups),
                              None, 0, 0, 0.0,
                              {"reason": f"closed form unavailable for {estimator}"})
    rng = np.random.default_rng(seed)
    m = data.num_groups
    stats = _group_pilot_stats(data, rng, pilot_n)
    z = _norm_ppf(1.0 - delta / (2.0 * m))
    eps_i = epsilon / np.sqrt(m)
    scale = data.scale if est.needs_population_scale else np.ones((m,))
    if estimator == "var":
        # Var(s^2) ~ (mu4 - sigma^4) / n  (delta method)
        avar = np.maximum(stats[:, 3] - stats[:, 1] ** 2, 1e-12)
    else:
        avar = np.maximum(stats[:, 1], 1e-12)
    n = np.ceil((z**2) * avar * (scale**2) / (eps_i**2)).astype(np.int64)
    n = np.minimum(np.maximum(n, 2), data.sizes)
    # Final answer from a sample of the computed size.
    key = S.root_key(seed)
    n_cap = S.bucket_cap(int(n.max()))
    sample, mask = S.stratified_sample(key, data.values, data.offsets, n,
                                       n_cap)
    aux = torch.stack([est.prepare(xg) for xg in sample])
    theta = est.apply(aux, mask).cpu().numpy() * scale[:, None]
    return BaselineResult(
        "BLK", True, n, theta, int(n.sum() + pilot_n * m), 1,
        time.perf_counter() - t0, {"z": z, "pilot_n": pilot_n})


def run_sps(
    data: GroupedData, estimator: str, epsilon_rel: float, delta: float,
    *, seed: int = 0,
) -> BaselineResult:
    """Sample+Seek flavored baseline: full scan + measure-biased sample.

    Sample size from the distribution-precision bound n >= log(2/delta) /
    (2 eps^2); the full scan (to build measure weights: the whole column,
    copied to the host) dominates cost at scale, reproducing Fig. 3(d)'s
    behaviour.
    """
    t0 = time.perf_counter()
    est = get_estimator(estimator)
    vals = data.values[:, 0].cpu().numpy()
    N = len(vals)
    # ---- the full scan (cost accounted below) ----
    w = np.abs(vals) + 1e-12
    w_sum_per_group = np.add.reduceat(w, data.offsets[:-1])
    n_draw = int(np.ceil(np.log(2.0 / delta) / (2.0 * epsilon_rel**2)))
    rng = np.random.default_rng(seed)
    m = data.num_groups
    n = np.zeros((m,), np.int64)
    theta = np.zeros((m, 1))
    for i in range(m):
        lo, hi = data.offsets[i], data.offsets[i + 1]
        k = int(min(n_draw, hi - lo))
        p = w[lo:hi] / w_sum_per_group[i]
        idx = rng.choice(hi - lo, size=k, p=p, replace=True)
        x = vals[lo + idx]
        # measure-biased AVG: the self-normalized importance estimate.
        iw = 1.0 / (p[idx] * (hi - lo))
        theta[i, 0] = np.sum(x * iw) / np.sum(iw)
        n[i] = k
    scale = data.scale if est.needs_population_scale else np.ones((m,))
    theta = theta * scale[:, None]
    return BaselineResult(
        "SPS", True, n, theta, int(N + n.sum()), 1,
        time.perf_counter() - t0, {"n_draw": n_draw, "full_scan_rows": N})


def run_ifocus(
    data: GroupedData, estimator: str, delta: float,
    *, step0: int = 200, growth: float = 1.5, max_rounds: int = 200, seed: int = 0,
) -> BaselineResult:
    """IFocus: grow samples until Hoeffding CIs of all group means separate.

    CI half-width: R * sqrt(log(2 m T / delta) / (2 n)) with R the data range
    (estimated from the pilot) -- the conservative concentration bound that
    makes IFocus need several-times-larger samples than OrderMiss (Fig. 4).
    Each round's rows are gathered on the device in one indexing.
    """
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    m = data.num_groups
    stats = _group_pilot_stats(data, rng, 500)
    R = np.maximum(stats[:, 2], 1e-9)
    n = np.full((m,), step0, np.int64)
    sums = np.zeros((m,))
    cnts = np.zeros((m,), np.int64)
    total = 0

    def draw(groups, sizes):
        idx = [rng.integers(data.offsets[i], data.offsets[i + 1], size=k)
               for i, k in zip(groups, sizes)]
        for i, x in zip(groups, _gather_host(data, idx)):
            sums[i] += x.sum()
            cnts[i] += len(x)
        return sum(len(x) for x in idx)

    total += draw(range(m), [int(k) for k in n])
    rounds = 1
    while rounds < max_rounds:
        mu = sums / np.maximum(cnts, 1)
        hw = R * np.sqrt(np.log(2 * m * max_rounds / delta) / (2 * np.maximum(cnts, 1)))
        order = np.argsort(mu)
        unresolved = []
        for a, b in zip(order[:-1], order[1:]):
            if mu[b] - hw[b] <= mu[a] + hw[a]:  # CIs overlap
                unresolved.extend([a, b])
        if not unresolved:
            break
        step = int(step0 * growth ** rounds)
        groups = sorted(set(unresolved))
        total += draw(groups, [int(min(step, data.offsets[i + 1]
                                       - data.offsets[i])) for i in groups])
        rounds += 1
    mu = sums / np.maximum(cnts, 1)
    return BaselineResult(
        "IFOCUS", rounds < max_rounds, cnts.astype(np.int64), mu[:, None],
        total, rounds, time.perf_counter() - t0, {"range_est": R})


def run_minibatch(
    data: GroupedData, estimator: str, epsilon: float, delta: float,
    *, step: int = 500, B: int = 500, max_iters: int = 400, seed: int = 0,
) -> BaselineResult:
    """Model-free searcher (iOLAP-style): n += step until bootstrap e <= eps.

    The paper's motivating strawman -- a huge number of trials (SS1).  Each
    trial is a fresh stratified sample and the generic bootstrap on the
    data's device, as in the reference."""
    t0 = time.perf_counter()
    est = get_estimator(estimator)
    m = data.num_groups
    scale = (np.asarray(data.scale, np.float32)
             if est.needs_population_scale else np.ones((m,), np.float32))
    scale_dev = torch.as_tensor(scale, device=data.device)
    key = S.root_key(seed)
    n = np.full((m,), step, np.int64)
    total = 0
    it = 0
    e = np.inf
    theta = None
    while it < max_iters:
        it += 1
        n = np.minimum(n, data.sizes)
        total += int(n.sum())
        n_cap = S.bucket_cap(int(n.max()))
        key, k1 = keylib.split(key)
        e_dev, th = _mb_estimate(est, k1, data, n, n_cap, scale_dev, delta, B)
        e, theta = float(e_dev), th.cpu().numpy()
        if e <= epsilon:
            break
        n = n + step
    return BaselineResult(
        "MINIBATCH", e <= epsilon, n, theta, total, it,
        time.perf_counter() - t0, {"step": step, "error": e})


def _mb_estimate(est, key, data: GroupedData, n_vec, n_cap: int,
                 scale: torch.Tensor, delta: float, B: int):
    """One MiniBatch trial: a stratified sample of ``n_vec`` rows a group
    under the first half of ``key``, its generic bootstrap error under the
    second."""
    ks, kb = keylib.split(key)
    sample, mask = S.stratified_sample(ks, data.values, data.offsets, n_vec,
                                       n_cap)
    return B_.estimate_error(est, sample, mask, scale, kb, delta, B=B)
