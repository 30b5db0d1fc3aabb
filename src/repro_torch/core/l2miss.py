"""L2Miss (paper Algorithm 3): the concrete SSO algorithm for the L2 metric.

The host loop is Algorithm 1 (core/framework.py); the numeric subroutines
put their work on the data's device:

  SAMPLE    SampleStore permuted prefixes (core/sampling.py): numpy
            permutations, one device gather of the new rows
  ESTIMATE  the moments entry (kernels/poisson_bootstrap/ops.py
            ``estimate_error_moments``: one Poisson-bootstrap kernel launch
            over the m groups) or the generic bootstrap (core/bootstrap.py
            ``estimate_error``)
  PREDICT   f32 WLS fit + Algorithm-2 diagnostic + Eq.-13 closed form on the
            device (core/error_model.py), then the trust region and the
            ``ceil`` in numpy float64 on the host

**Choosing the ESTIMATE.**  ``MissConfig.use_kernel`` picks the route for
the moment estimators (avg/proportion/sum/count/var/std); every other
estimator always takes the generic route.  ``True`` selects the moments
entry on any device: on a CUDA device it launches the CUDA kernel, on a CPU
device it runs the kernel's plain version (as the reference runs its kernel
in interpret mode there).  ``"auto"`` selects the moments entry on a CUDA
device and the generic route on the CPU (the reference's choice off its
accelerator); ``False`` always takes the generic route.  The two routes draw
different random streams (the kernel's counter hash against threefry
uniforms), as in the reference.  This choice is the host route's own:
``kernels.resolve_use_kernel`` keeps refusing ``True`` on a CPU device for
the fused path.

Implementation hardening vs. the paper, as in the reference:
  * growth guard: when the constraint is unmet, n^(k+1) >= n^(k) + 1;
  * exact fallback: a group's predicted size is clamped at its population;
  * error floor: log e is clamped at LOG_FLOOR for degenerate zero errors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.poisson_bootstrap import ops as pb_ops
from . import bootstrap, error_model, sampling
from . import keys as keylib
from .estimators import Estimator, evaluate, get as get_estimator
from .framework import MissFailure, MissTrace, run_miss

LOG_FLOOR = -60.0


@dataclasses.dataclass
class MissConfig:
    """Parameters of Algorithm 3 (defaults follow paper SS6)."""

    epsilon: float                      # error bound (absolute, post-Gamma)
    delta: float = 0.05                 # error probability
    B: int = 500                        # bootstrap resamples
    n_min: int = 100                    # initialization interval I_n
    n_max: int = 200
    l: Optional[int] = None             # init length; default 5*(m+1) (SS6.3)
    tau: float = 1e-3                   # Algorithm-2 failure threshold
    max_iters: int = 64
    budget_rows: Optional[int] = None   # resource cap (failure type 1, SS4.3.4)
    backend: str = "poisson"            # bootstrap backend
    metric: str = "l2"
    growth_guard: bool = True
    # Trust region: cap a prediction's growth of the total size at
    # growth_cap x the last iterate, scaling the allocation uniformly.
    growth_cap: float = 8.0
    seed: int = 0
    # True / False / "auto": the ESTIMATE route (module docstring).
    use_kernel: "bool | str" = "auto"
    # Non-uniform linear sampling cost (paper SS8): minimize sum_i c_i n_i.
    cost_weights: Optional[Tuple[float, ...]] = None


MOMENT_ENTRY = ("avg", "proportion", "sum", "count", "var", "std")


def moments_entry(mode: "bool | str", device) -> bool:
    """Whether the host route's ESTIMATE takes the moments entry for a
    moment estimator on ``device`` (see the module docstring)."""
    if isinstance(mode, str):
        if mode == "auto":
            return torch.device(device).type == "cuda"
        raise ValueError(
            f"use_kernel must be True, False or 'auto'; got {mode!r}")
    return bool(mode)


def _estimate_fn(est: Estimator, B: int, backend: str, metric: str,
                 use_entry: bool):
    """ESTIMATE ``fn(key, sample, mask, scale, delta) -> (e, theta)`` of one
    run.  The moments entry takes precedence over ``backend``, as in the
    reference."""
    if use_entry and est.name in MOMENT_ENTRY:
        def fn(key, sample, mask, scale, delta):
            return pb_ops.estimate_error_moments(
                est.name, sample, mask, scale, key, delta, B=B, metric=metric)
    else:
        def fn(key, sample, mask, scale, delta):
            return bootstrap.estimate_error(
                est, sample, mask, scale, key, delta, B=B, backend=backend,
                metric=metric)
    return fn


def allocate(n_hat: np.ndarray, beta: np.ndarray, profile_n: np.ndarray,
             profile_e: np.ndarray, prev: np.ndarray,
             cfg: MissConfig) -> np.ndarray:
    """PREDICT's host float64 step from the fit's f32 ``n_hat``: the
    allocation before its ``ceil``.

    Local-model correction: if the Eq.-13 total lands at or below the
    proven-direction step from the last iterate, the whole allocation is
    upscaled uniformly (keeping its cost-weighted shape); then the trust
    region caps the total (cost-weighted) size at ``growth_cap`` times
    ``prev``'s.
    """
    alloc = np.maximum(np.asarray(n_hat).astype(np.float64), 1.0)
    s = max(float(beta[1:].sum()), 1e-3)
    ratio = float(profile_e[-1]) / cfg.epsilon
    cost = (np.asarray(cfg.cost_weights, np.float64)
            if cfg.cost_weights is not None else np.ones(alloc.shape[0]))
    if ratio > 1.0:
        floor_alloc = profile_n[-1] * ratio ** (1.0 / s)
        c_hat = float((alloc * cost).sum())
        c_floor = float((floor_alloc * cost).sum())
        if c_hat < c_floor:
            alloc = alloc * (c_floor / c_hat)
    c_alloc = float((alloc * cost).sum())
    c_cap = float((prev * cfg.growth_cap * cost).sum()) + 1.0
    if c_alloc > c_cap:
        alloc = alloc * (c_cap / c_alloc)
    return alloc


class _L2MissSubroutines:
    """Algorithm 3's concrete INITIALIZE/SAMPLE/ESTIMATE/PREDICT."""

    def __init__(self, data: sampling.GroupedData, est: Estimator,
                 cfg: MissConfig,
                 store: "sampling.SampleStore | sampling.SampleStoreBinding | None" = None):
        self.data = data
        self.est = est
        self.cfg = cfg
        self.m = data.num_groups
        self.sizes = data.sizes.astype(np.int64)
        self.device = data.device
        self.key = sampling.root_key(cfg.seed)
        # Incremental permuted-prefix sampler: nested across iterations; a
        # caller may pass a resident store to reuse prefixes across queries.
        self.store = store if store is not None else sampling.SampleStore(
            data, seed=cfg.seed)
        # A resident store's counter is cumulative across queries; this
        # run's rows are the delta from here.
        self._rows_at_start = int(self.store.rows_touched)
        self.scale = (
            np.asarray(data.scale, np.float32)
            if est.needs_population_scale
            else np.ones((self.m,), np.float32)
        )
        self.last_fit: Optional[error_model.ErrorModelFit] = None
        self._scale_dev = torch.as_tensor(self.scale, device=self.device)
        self._estimate = _estimate_fn(
            est, cfg.B, cfg.backend, cfg.metric,
            moments_entry(cfg.use_kernel, self.device))
        self._prev_n: Optional[np.ndarray] = None
        self._all_clamped = False
        self._init_bases: Optional[np.ndarray] = None
        self._l = 0
        self._next_it = 0

    def _split(self):
        self.key, sub = keylib.split(self.key, 2)
        return sub

    # -- INITIALIZE (SS4.4) -------------------------------------------------
    def initialize(self) -> np.ndarray:
        cfg = self.cfg
        # Default l: >= m + 2 for the regression, 5(m + 1) capped at 16.
        l = cfg.l if cfg.l is not None else max(
            self.m + 2, min(5 * (self.m + 1), 16))
        rows = sampling.two_point_init_sizes(self._split(), self.m, l,
                                             cfg.n_min, cfg.n_max)
        rows = np.minimum(rows, self.sizes[None, :])
        # Init probes read STACKED permutation windows [base_k, base_k +
        # n_k), disjoint across k, so the WLS fit sees independent draws;
        # their union is the prefix the prediction phase then reuses.
        self._init_bases = np.concatenate([
            np.zeros((1, self.m), np.int64),
            np.cumsum(rows[:-1], axis=0, dtype=np.int64),
        ])
        self._l = l
        return rows

    # -- SAMPLE (incremental) + ESTIMATE -------------------------------------
    def _base_for(self, it: int):
        if self._init_bases is not None and it < self._l:
            return self._init_bases[it]
        return None

    def sample_cost(self, n_vec: np.ndarray) -> int:
        """Rows the next SAMPLE call will gather (delta vs resident)."""
        return self.store.sample_cost(
            np.asarray(n_vec, np.int64), self._base_for(self._next_it))

    def sample(self, n_vec: np.ndarray, it: int):
        n_vec = np.minimum(np.asarray(n_vec, np.int64), self.sizes)
        sample, mask = self.store.sample(n_vec, self._base_for(it))
        self._next_it = it + 1
        return n_vec, sample, mask

    def estimate(self, handle, it: int) -> Tuple[float, np.ndarray]:
        _, sample, mask = handle
        e, theta = self._estimate(self._split(), sample, mask,
                                  self._scale_dev, self.cfg.delta)
        return float(e), theta.cpu().numpy()

    # -- PREDICT (SS4.3): WLS fit -> diagnose -> Eq. 13 ----------------------
    def predict(self, profile_n: np.ndarray, profile_e: np.ndarray, it: int):
        cfg = self.cfg
        dev = self.device
        loge = np.log(np.maximum(profile_e, np.exp(LOG_FLOOR)))
        f32 = dict(dtype=torch.float32, device=dev)
        cw = (torch.as_tensor(cfg.cost_weights, **f32)
              if cfg.cost_weights is not None else None)
        n_hat, fit = error_model.fit_and_predict(
            torch.as_tensor(profile_n, **f32), torch.as_tensor(loge, **f32),
            torch.ones((len(loge),), **f32),
            torch.log(torch.tensor(cfg.epsilon, **f32)), cfg.tau,
            cost_weights=cw)
        self.last_fit = fit
        if int(fit.status) == error_model.DIAG_FAILURE:
            raise MissFailure("sum(beta) <= tau: error will not shrink with n")
        beta = fit.beta.cpu().numpy()
        prev = self._prev_n if self._prev_n is not None else profile_n.max(
            axis=0)
        alloc = allocate(n_hat.cpu().numpy(), beta, profile_n, profile_e,
                         prev, cfg)
        n_next = np.ceil(alloc).astype(np.int64)
        if cfg.growth_guard:
            n_next = np.maximum(n_next, prev + 1)
        clamped = n_next >= self.sizes
        n_next = np.minimum(n_next, self.sizes)
        self._all_clamped = bool(clamped.all())
        self._prev_n = n_next
        info = {
            "beta": beta,
            "r2": float(fit.r2),
            "diag_status": int(fit.status),
            "all_clamped": self._all_clamped,
        }
        return n_next, info


def exact_answer(data: sampling.GroupedData, est: Estimator) -> np.ndarray:
    """Ground-truth theta on the full dataset, group by group through
    ``evaluate`` (a full sort for quantiles: ``torch.quantile`` refuses
    inputs above 2**24 elements)."""
    outs = []
    for i in range(data.num_groups):
        seg = data.values[int(data.offsets[i]):int(data.offsets[i + 1])]
        th = evaluate(est, seg).cpu().numpy()
        if est.needs_population_scale:
            th = th * data.scale[i]
        outs.append(th)
    return np.stack(outs)


def run_l2miss(
    data: sampling.GroupedData,
    estimator: "Estimator | str",
    cfg: MissConfig,
    store: "sampling.SampleStore | sampling.SampleStoreBinding | None" = None,
) -> MissTrace:
    """Run Algorithm 3 end to end on a grouped dataset.

    ``store``: an optional resident :class:`~.sampling.SampleStore` (or a
    binding of one) whose nested prefixes this run extends and reuses; by
    default a run-local store, which still makes ``total_sampled``
    delta-based across the run's iterations.
    """
    est = get_estimator(estimator) if isinstance(estimator, str) else estimator
    subs = _L2MissSubroutines(data, est, cfg, store=store)
    trace = run_miss(
        subs, cfg.epsilon, max_iters=cfg.max_iters, budget_rows=cfg.budget_rows
    )
    if subs.last_fit is not None:
        trace.info.setdefault("beta", subs.last_fit.beta.cpu().numpy())
        trace.info.setdefault("r2", float(subs.last_fit.r2))
    trace.info.setdefault(
        "rows_touched", int(subs.store.rows_touched) - subs._rows_at_start)
    return trace
