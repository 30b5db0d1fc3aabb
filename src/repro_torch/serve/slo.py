"""Overload scheduling policies of the lane pool: deadline-driven
degradation, load shedding and weighted fair queueing.

* :class:`CostModel` -- an online cost model keyed to the pool's ESTIMATE
  width ladder (``core.fused.bucket_ladder``): EWMA seconds a loop tick per
  rung, EWMA resident ticks and watermark growth, and a per-func sqrt-law
  error coefficient ``c ~ eps * sqrt(watermark)`` learned from retirements.
* :class:`AdmissionController` -- at admission, compares the predicted
  service time against the remaining deadline budget: admit, relax epsilon
  along the Eq.-13 closed form (:func:`eps_for_budget`) to the largest rung
  that fits, or SHED (answer at once from an ``n_min`` pilot with its
  measured error bar).  A degraded or shed answer reports the (epsilon, B)
  it delivered and satisfies that bound.
* :class:`FairQueue` -- self-clocked weighted fair queueing over tenants:
  ``vft = max(v, finish[tenant]) + cost / weight[tenant]`` at submit; the
  pool's admission order sorts on it within a priority class.

Host-side numpy only: a degraded lane is a normal lane at the relaxed
epsilon, so the device programs do not change.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# A shed pilot drops B to a quarter of the pool's replicate count (floored
# here): the answer is best-effort by definition, and ONE pilot program per
# estimator func keeps the shed path a single warm dispatch -- the delivered
# B is recorded on the response either way.
PILOT_B_FLOOR = 16


# -- Eq. 13 closed form, both directions -------------------------------------

def predict_n0(beta: np.ndarray, epsilon: float, *, n_min: int,
               margin: float = 1.10) -> np.ndarray:
    """Eq.-13 Lagrange optimum on fitted coefficients: the (m,) allocation
    predicted to satisfy ``epsilon`` (mirrors ``WarmCache.predict_n0``;
    used to re-aim a warm lane's tick-0 jump after degradation relaxed its
    bound)."""
    b0 = float(beta[0])
    b = np.maximum(np.asarray(beta[1:], np.float64), 1e-9)
    s = float(b.sum())
    log_lambda = (b0 - float((b * np.log(b)).sum())
                  - math.log(float(epsilon))) / s
    with np.errstate(over="ignore"):
        n_hat = b * np.exp(log_lambda)
    n0 = np.where(np.isfinite(n_hat), np.ceil(n_hat * margin),
                  np.float64(n_min)).astype(np.int64)
    return np.maximum(n0, n_min)


def eps_for_budget(beta: np.ndarray, n_total: float) -> float:
    """Eq. 13 inverted: the smallest epsilon the fitted log-log model
    predicts satisfiable within a TOTAL budget of ``n_total`` rows.

    From the closed form ``n_i = b_i * exp(log_lambda)`` with
    ``sum n_i = s * exp(log_lambda) = N``:

        ln eps = b0 - sum_i b_i ln b_i - s * ln(N / s)

    -- the degradation curve a deadline walks DOWN: shrink the budget,
    read off the bound the model can still promise.
    """
    b0 = float(beta[0])
    b = np.maximum(np.asarray(beta[1:], np.float64), 1e-9)
    s = float(b.sum())
    ln_eps = (b0 - float((b * np.log(b)).sum())
              - s * math.log(max(float(n_total), 1.0) / s))
    return float(np.exp(np.clip(ln_eps, -60.0, 60.0)))


# -- online bucket-ladder cost model -----------------------------------------

class CostModel:
    """EWMA cost observations keyed to the pool's static ESTIMATE ladder.

    Three learned quantities, all O(1) state:

    * ``seconds/loop-tick`` per ladder rung (a dispatch's wall time is
      attributed to the max rung among its busy tiers -- the compute
      width the step actually padded to), with a rung-free global
      fallback;
    * ``ticks-in-lane`` EWMA (how many loop ticks a cold resident query
      holds its lane; warm lanes are predicted at the 2-tick verify
      shape);
    * per-func sqrt-law coefficient ``c = eps * sqrt(watermark)`` from
      retirements -- the single-knob error model (``e ~ c / sqrt(n)``)
      that predicts a cold query's final watermark for ANY bound, the
      fallback when no fitted Eq.-13 coefficients are attached.

    No observations -> no predictions -> no degradation: the controller
    admits optimistically until the pool has taught the model (first
    queries of a session are never degraded by an unprimed model).
    """

    def __init__(self, widths: Sequence[int], *, alpha: float = 0.25):
        if not widths:
            raise ValueError("cost model needs a non-empty ladder")
        self.widths: Tuple[int, ...] = tuple(int(w) for w in widths)
        self.alpha = float(alpha)
        self._tick_s: Dict[int, float] = {}     # rung -> EWMA seconds/tick
        self._tick_s_any: Optional[float] = None
        self._ticks: Optional[float] = None     # EWMA resident loop ticks
        self._growth: Optional[float] = None    # EWMA watermark rows/tick
        self._coef: Dict[str, float] = {}       # func -> EWMA eps*sqrt(wm)
        self.rounds_observed = 0
        self.retirements_observed = 0

    def _ewma(self, old: Optional[float], new: float) -> float:
        return new if old is None else (1 - self.alpha) * old \
            + self.alpha * new

    def rung(self, watermark: int) -> int:
        for w in self.widths:
            if watermark <= w:
                return w
        return self.widths[-1]

    def observe_round(self, seconds: float, loop_ticks: int,
                      rung: int) -> None:
        """One scheduling round: ``seconds`` of wall time covering
        ``loop_ticks`` loop ticks at compute rung ``rung``."""
        per_tick = seconds / max(loop_ticks, 1)
        r = self.rung(rung)
        self._tick_s[r] = self._ewma(self._tick_s.get(r), per_tick)
        self._tick_s_any = self._ewma(self._tick_s_any, per_tick)
        self.rounds_observed += 1

    def observe_retirement(self, func: str, epsilon: float, watermark: int,
                           loop_ticks: int) -> None:
        """One retired lane: what bound it ran at, how wide it grew, how
        long it stayed resident."""
        if loop_ticks > 0:
            self._ticks = self._ewma(self._ticks, float(loop_ticks))
            if watermark > 0:
                # The SAMPLE extend is capped per loop tick, so residency
                # scales with the final watermark: learn rows-per-tick and
                # predict ticks ~ watermark / growth -- a degraded
                # (smaller) target retires proportionally sooner, which is
                # the whole budget the ladder walk-down trades on.
                self._growth = self._ewma(
                    self._growth, float(watermark) / float(loop_ticks))
        if epsilon > 0 and watermark > 0:
            c = float(epsilon) * math.sqrt(float(watermark))
            self._coef[func] = self._ewma(self._coef.get(func), c)
        self.retirements_observed += 1

    def tick_seconds(self, rung: int) -> Optional[float]:
        v = self._tick_s.get(self.rung(rung))
        return v if v is not None else self._tick_s_any

    def predict_watermark(self, func: str, epsilon: float,
                          warm_n0=None) -> Optional[int]:
        """Predicted final per-group watermark (it sets the ESTIMATE rung).
        A warm-cache prediction is authoritative; else the learned
        sqrt-law inverts ``eps = c / sqrt(n)``."""
        if warm_n0 is not None:
            return int(np.max(warm_n0))
        c = self._coef.get(func)
        if c is None or epsilon <= 0:
            return None
        return int(min((c / float(epsilon)) ** 2, float(self.widths[-1])))

    def predict_ticks(self, *, warm: bool,
                      watermark: Optional[int] = None) -> Optional[float]:
        if warm:
            # Warm lanes jump to the prediction at tick 0 and verify: the
            # 2-tick shape whatever the cold EWMA says.
            return 2.0
        if watermark is not None and self._growth:
            return max(1.0, float(watermark) / self._growth)
        return self._ticks

    def predict_service_s(self, func: str, epsilon: float, *,
                          warm_n0=None) -> Optional[Tuple[float, int]]:
        """(predicted lane-resident seconds, predicted watermark), or None
        while the model is unprimed."""
        wm = self.predict_watermark(func, epsilon, warm_n0=warm_n0)
        if wm is None:
            return None
        ticks = self.predict_ticks(warm=warm_n0 is not None, watermark=wm)
        per_tick = self.tick_seconds(self.rung(wm))
        if ticks is None or per_tick is None:
            return None
        return ticks * per_tick, wm


# -- deadline-driven degradation / shedding ----------------------------------

@dataclasses.dataclass(frozen=True)
class DegradePlan:
    """The admission decision for one deadline-carrying ticket."""
    action: str                      # "admit" | "degrade" | "shed"
    epsilon: float                   # delivered bound ("admit": requested)
    predicted_s: Optional[float] = None   # model's service-time estimate


class AdmissionController:
    """Decide admit / degrade / shed for a ticket against its deadline.

    ``max_degrade`` is the quality floor: a bound the Eq.-13 walk would
    relax past ``max_degrade * requested`` is shed instead (an answer that
    loose is the pilot's job, not a lane's).
    """

    def __init__(self, widths: Sequence[int], *, num_groups: int,
                 n_min: int, max_degrade: float = 8.0, alpha: float = 0.25):
        self.cost = CostModel(widths, alpha=alpha)
        self.m = int(num_groups)
        self.n_min = int(n_min)
        self.max_degrade = float(max_degrade)
        if self.max_degrade < 1.0:
            raise ValueError("max_degrade must be >= 1.0")

    def hopeless(self, *, queue_ahead: int, busy: int, lanes: int,
                 deadline_at: float, now: float) -> bool:
        """Submit-time shed decision: is the deadline unmeetable even by
        the CHEAPEST degraded run, once the predicted queue wait is paid?

        An instant on-time pilot answer beats a guaranteed-late full one
        -- that is the bounded-response-time half of the contract.  The
        wait estimate is deliberately crude (mean service x backlog depth
        / lanes); it only needs to separate "hopeless at submit" from
        "let admission degrade it later".  Unprimed model -> never
        hopeless (queue and find out).
        """
        remaining = deadline_at - now
        if remaining <= 0:
            return True
        ticks = self.cost.predict_ticks(warm=False)
        per_tick = self.cost.tick_seconds(self.cost.widths[-1])
        if ticks is None or per_tick is None:
            return False
        mean_service = ticks * per_tick
        wait = (queue_ahead + 0.5 * busy) / max(lanes, 1) * mean_service
        floor = self.cost.rung(self.n_min)
        fticks = self.cost.predict_ticks(warm=False, watermark=floor) or 2.0
        fper = self.cost.tick_seconds(floor) or per_tick
        return wait + fticks * fper > remaining

    def plan(self, *, func: str, epsilon: float, deadline_at: Optional[float],
             now: float, warm_n0=None, warm_beta=None) -> DegradePlan:
        if deadline_at is None:
            return DegradePlan("admit", float(epsilon))
        remaining = deadline_at - now
        if remaining <= 0:
            return DegradePlan("shed", float(epsilon), predicted_s=None)
        pred = self.cost.predict_service_s(func, epsilon, warm_n0=warm_n0)
        if pred is None:
            return DegradePlan("admit", float(epsilon))   # unprimed model
        service_s, wm = pred
        if service_s <= remaining:
            return DegradePlan("admit", float(epsilon), predicted_s=service_s)
        # The full run cannot fit: walk the ladder for the LARGEST rung
        # whose predicted cost fits the remaining budget (looser bound =
        # smaller watermark = FEWER resident ticks at a cheaper rung).
        warm = warm_n0 is not None
        floor_rung = self.cost.rung(self.n_min)
        best_w: Optional[int] = None
        for w in self.cost.widths:
            if w >= wm:
                break
            if w < floor_rung:
                continue          # a lane never runs below n_min anyway
            ticks = self.cost.predict_ticks(warm=warm, watermark=w) or 2.0
            per_tick = self.cost.tick_seconds(w)
            if per_tick is not None and ticks * per_tick <= remaining:
                best_w = w        # ascending scan: keeps the largest fit
        if best_w is None:
            return DegradePlan("shed", float(epsilon), predicted_s=service_s)
        if warm_beta is not None and np.asarray(warm_beta).ndim == 1:
            # Fitted coefficients attached: the exact Eq.-13 inversion at
            # the reduced TOTAL budget (per-group rung x groups).
            eps2 = eps_for_budget(np.asarray(warm_beta), best_w * self.m)
        else:
            # sqrt-law fallback: e ~ c / sqrt(n).
            eps2 = float(epsilon) * math.sqrt(wm / best_w)
        eps2 = max(eps2, float(epsilon))
        if eps2 > self.max_degrade * float(epsilon):
            return DegradePlan("shed", float(epsilon), predicted_s=service_s)
        return DegradePlan("degrade", eps2, predicted_s=service_s)


# -- per-tenant weighted fair queueing ---------------------------------------

class FairQueue:
    """Self-clocked weighted fair queueing (SCFQ) over tenants.

    :meth:`stamp` assigns a submitting ticket its virtual finish time;
    :meth:`on_admit` advances the virtual clock to the admitted ticket's
    tag.  With service order = ascending vft, tenant i receives capacity
    proportional to ``weight[i]`` over any backlogged interval, and a
    ticket is overtaken by at most one cost quantum of later-submitted
    work per competing tenant -- the starvation-freedom bound
    ``tests/test_serve_wfq.py`` asserts.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None, *,
                 default_weight: float = 1.0):
        self.weights = {str(k): float(v) for k, v in (weights or {}).items()}
        if any(w <= 0 for w in self.weights.values()):
            raise ValueError("tenant weights must be positive")
        self.default_weight = float(default_weight)
        self._finish: Dict[str, float] = {}   # tenant -> last finish tag
        self.v = 0.0                          # virtual clock (self-clocked)

    def weight(self, tenant: str) -> float:
        return self.weights.get(tenant, self.default_weight)

    def stamp(self, tenant: str, cost: float = 1.0) -> float:
        """Virtual finish time for one submitting ticket of ``tenant``."""
        start = max(self.v, self._finish.get(tenant, 0.0))
        vft = start + max(float(cost), 1e-9) / self.weight(tenant)
        self._finish[tenant] = vft
        return vft

    def on_admit(self, vft: float) -> None:
        """Self-clocking: the served ticket's tag becomes the clock."""
        self.v = max(self.v, vft)
