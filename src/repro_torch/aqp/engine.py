"""The AQP engine: Listing-1 queries -> MISS-driven samples -> answers.

The engine owns one resident :class:`~repro_torch.core.sampling.SampleStore`
per dataset: pilot estimates, every MISS iteration and every query it
serves draw nested permuted prefixes from it, so the rows touched across a
workload grow with the largest sample needed, not with the sum of every
redraw.  A predicate query folds its predicate into an indicator column on
the data's device and binds it to the same permutations.

:meth:`AQPEngine.execute` routes each metric to L2Miss or its extension
(linf, l1, lp, diff, order), resolves relative bounds against a pilot
estimate and sends GROUP BY queries to the grouped lane block
(``fused_grouped``).  :meth:`AQPEngine.exact` answers moment functions with
one launch of the exact segment-aggregate kernel over all groups and every
other function group by group through ``evaluate``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import estimators, extensions
from ..core.framework import MissTrace
from ..core.l2miss import MissConfig, exact_answer, run_l2miss
from ..core.sampling import GroupedData, SampleStore, root_key
from ..kernels import resolve_use_kernel
from ..kernels.segment_agg import ops as seg_ops
from .query import Query, compile_predicate

_MOMENT_FUNCS = ("avg", "proportion", "sum", "count", "var", "std")


def _exact_finish(func: str, n, s, s2) -> np.ndarray:
    """A moment function's exact value from per-group (count, sum, sum of
    squares), in float64."""
    mean = s / np.maximum(n, 1e-12)
    if func not in ("var", "std"):
        return mean
    var = s2 / np.maximum(n, 1e-12) - mean * mean
    return np.sqrt(np.maximum(var, 0.0)) if func == "std" else var


def _predicate_fn(pred):
    """Opaque callables run as given; structured ASTs compile to torch."""
    return compile_predicate(pred) if isinstance(pred, tuple) else pred


@dataclasses.dataclass
class AQPEngine:
    data: GroupedData
    B: int = 500
    n_min: int = 1000
    n_max: int = 2000
    seed: int = 0
    # True / False / "auto": the ESTIMATE route of the moment functions
    # (core/l2miss.py) and, for GROUP BY, the fused block's kernel switch.
    use_kernel: "bool | str" = "auto"
    store: Optional[SampleStore] = None

    def __post_init__(self):
        if self.store is None:
            self.store = SampleStore(self.data, seed=self.seed)
        self._gid: Optional[torch.Tensor] = None    # exact(): group ids

    @property
    def rows_touched(self) -> int:
        """Cumulative rows gathered across every query served so far."""
        return self.store.rows_touched

    def refresh(self, data: Optional[GroupedData] = None) -> None:
        """Invalidate the resident store after a data update."""
        if data is not None:
            self.data = data
        self._gid = None
        self.store.refresh(self.data)

    def _pilot_scale(self, q: Query) -> float:
        """|theta| for relative bounds, from a pilot of the store's first
        min(2000, |D_i|) rows a group (the rows MISS then extends)."""
        est = estimators.get(q.func)
        sample, mask = self.store.sample(np.minimum(2000, self.data.sizes))
        th = torch.stack([est.apply(est.prepare(xg), mg)
                          for xg, mg in zip(sample, mask)]).cpu().numpy()
        scale = (self.data.scale if est.needs_population_scale
                 else np.ones(self.data.num_groups))
        return float(np.linalg.norm(th[:, 0] * scale))

    def _config(self, q: Query, epsilon: float) -> MissConfig:
        return MissConfig(
            epsilon=epsilon, delta=q.delta, B=self.B, n_min=self.n_min,
            n_max=self.n_max, seed=self.seed, use_kernel=self.use_kernel)

    def _bind_predicate(self, q: Query):
        """``(data, store)`` with the predicate folded into the measure: an
        f32 indicator column on the data's device, bound to the store's
        permutations.  Passthrough without a predicate."""
        if q.predicate is None:
            return self.data, self.store
        ind = _predicate_fn(q.predicate)(self.data.values)
        ind = torch.as_tensor(ind, device=self.data.device).to(torch.float32)
        data = GroupedData(ind, self.data.offsets.copy(),
                           self.data.scale.copy(), device=self.data.device)
        return data, self.store.bind(data.values)

    def execute_grouped(self, q: Query):
        """GROUP BY: one shared-scan lane block (``fused_grouped``), each
        group's lane verifying its own ``(epsilon, delta)``.  Returns the
        per-group :class:`~repro_torch.core.fused.FusedResult`."""
        from ..core import fused

        if q.metric != "l2":
            raise ValueError(
                f"grouped queries run per-group l2 verification; got "
                f"metric {q.metric!r}")
        estimators.moment_family_index(q.func)   # raises for non-moment
        data, _ = self._bind_predicate(q)
        eps = q.epsilon
        if eps is None:
            eps = q.epsilon_rel * self._pilot_scale(q)
        scale = estimators.population_scale_row(q.func, data.scale)
        return fused.fused_grouped(
            data.values, np.asarray(data.offsets), scale,
            root_key(self.seed), float(eps), float(q.delta),
            est_name=q.func, B=self.B, n_min=self.n_min, n_max=self.n_max,
            use_kernel=resolve_use_kernel(self.use_kernel, data.device))

    def execute(self, q: Query) -> MissTrace:
        if q.group_by:
            return self.execute_grouped(q)
        data, store = self._bind_predicate(q)
        eps = q.epsilon
        if eps is None and q.metric != "order":
            eps = q.epsilon_rel * self._pilot_scale(q)
        cfg = self._config(q, eps if eps is not None else 0.0)
        if q.metric == "l2":
            return run_l2miss(data, q.func, cfg, store=store)
        if q.metric == "linf":
            return extensions.run_maxmiss(data, q.func, cfg, store=store)
        if q.metric == "l1":
            return extensions.run_lpmiss(data, q.func, cfg, p=1, store=store)
        if q.metric == "lp":
            return extensions.run_lpmiss(data, q.func, cfg, p=q.lp,
                                         store=store)
        if q.metric == "diff":
            return extensions.run_diffmiss(data, q.func, cfg, store=store)
        if q.metric == "order":
            return extensions.run_ordermiss(data, q.func, cfg, store=store)
        raise ValueError(q.metric)

    def _group_ids(self) -> torch.Tensor:
        """(N,) int32 group id of every row, built once per data epoch."""
        if self._gid is None:
            dev = self.data.device
            sizes = torch.as_tensor(self.data.sizes, device=dev)
            self._gid = torch.repeat_interleave(
                torch.arange(self.data.num_groups, dtype=torch.int32,
                             device=dev), sizes)
        return self._gid

    def exact(self, q: Query) -> np.ndarray:
        """The exact answer ``(m, p)`` (float64 for the moment family).

        A moment function takes one launch of the segment-aggregate kernel
        (its plain version on a CPU tensor) for every group's count, sum
        and sum of squares (f32, summed in the kernel's order), finished in
        float64; any other function runs ``evaluate`` group by group.
        """
        data, _ = self._bind_predicate(q)
        est = estimators.get(q.func)
        if q.func not in _MOMENT_FUNCS:
            return exact_answer(data, est)
        x = data.values[:, 0]
        agg = seg_ops.segment_aggregate(self._group_ids(), x,
                                        torch.ones_like(x), data.num_groups)
        n, s, s2 = (agg[k].cpu().numpy().astype(np.float64)
                    for k in ("count", "sum", "sumsq"))
        th = _exact_finish(q.func, n, s, s2)
        if est.needs_population_scale:
            th = th * data.scale
        return th[:, None]
