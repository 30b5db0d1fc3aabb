"""Routing planner for the asynchronous serving session.

One explicit component owns the decision the old ``batch_fused in {True,
False, 'pool', 'auto'}`` tri-state hid inside ``AQPService.answer``: where
does a request run?  :meth:`Planner.route` inspects the query itself (func,
metric, bound form, predicate), the current pool occupancy, and how many
fusable requests are waiting in the same admission wave, and returns an
explicit :class:`Route`:

* ``POOL``    -- the continuous heterogeneous lane pool (phase D/E): real
  per-query latency, mid-flight admission, retire-and-refill.
* ``BATCHED`` -- phase-C closed-loop batching: one dispatch per func group,
  amortized latency (kept for benchmarks and forced-mode compat).
* ``LOOP``    -- one fused dispatch per query (the benchmark baseline, and
  the cheapest plan for a singleton with an idle pool: no pool build).
* ``HOST``    -- the host engine (order/diff/linf/lp metrics, relative
  bounds, predicates, quantiles -- everything the fused program can't run).

The planner also owns **continuous re-tuning** of the pool configuration.
The phase-E heuristics (`AQPService._auto_pool_config`) were frozen from
the FIRST pooled batch; here they become a sliding-window policy over the
live request stream:

* ``ticks_per_sync`` follows the epsilon spread of the last ``window``
  fusable requests (wide spread = straggler-prone -> sync every tick so
  freed lanes refill promptly; narrow spread -> fold two ticks per
  dispatch), and may be resized on a LIVE pool -- ``num_ticks`` only
  shapes future dispatches, never resident state, so the change is
  trajectory-invariant (at most one extra compile cache entry).
* lane count follows the peak fusable backlog (in-flight + waiting) seen
  in the window -- the continuous analogue of "cover the batch in two
  refill waves".  Resizing lanes means new carry shapes, so the planner
  only *requests* a rebuild (:meth:`pool_plan` -> ``rebuild=True``) and
  the session honors it at an idle point, rate-limited by ``cooldown``
  completed requests between rebuilds.

Explicitly configured values (``pool_lanes`` / ``pool_ticks_per_sync``)
pin the corresponding knob: the planner never re-tunes what the operator
fixed.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Deque, Optional

from ..aqp.query import Request

# The moment family shares one replicate computation (and hence one lane
# pool); SUM/COUNT ride with their population scale as their lanes' scale
# rows (paper SS2.2.1).
FUSABLE = ("avg", "proportion", "var", "std", "sum", "count")


class Route(enum.Enum):
    """Where a request runs (the planner's explicit routing decision)."""
    POOL = "pool"
    BATCHED = "batched"
    LOOP = "loop"
    HOST = "host"
    # Phase H: a warm-cache hit.  Coefficient hits ride the pool with a
    # warm-started lane (admitted into the narrowest tier -- their windows
    # are small by construction); exact-answer hits bypass the pool
    # entirely and are answered at poll() with zero dispatches.  Either
    # way the lane is short-lived, so warm requests are EXCLUDED from the
    # planner's sliding tuning windows -- a burst of repeats must not
    # inflate the lane-count drift signal and trigger pool rebuilds.
    WARM = "warm"


def fusable(request: Request) -> bool:
    """Whether the fused on-device path can serve this request as a SOLO
    lane: moment-family func, L2 metric, absolute bound, no predicate.
    Grouped requests are excluded -- they ride lane BLOCKS, not lanes
    (:func:`grouped_fusable`)."""
    q = request.query
    return (not q.group_by and q.metric == "l2" and q.func in FUSABLE
            and q.epsilon is not None and q.predicate is None)


def grouped_fusable(request: Request) -> bool:
    """Whether the shared-scan grouped block path (DESIGN.md phase I) can
    serve this GROUP BY request: same clause constraints as :func:`fusable`
    on a ``group_by`` query."""
    q = request.query
    return (q.group_by and q.metric == "l2" and q.func in FUSABLE
            and q.epsilon is not None and q.predicate is None)


@dataclasses.dataclass(frozen=True)
class PoolPlan:
    """The planner's current pool configuration."""
    lanes: int
    ticks_per_sync: int
    rebuild: bool       # lanes differ from the live pool: rebuild when idle


class Planner:
    """Route requests and continuously re-tune the pool configuration.

    ``mode`` forces a route for fusable requests (the compat surface of the
    old ``batch_fused``): ``Route.POOL`` / ``Route.BATCHED`` / ``Route.LOOP``
    force that path, ``None`` (auto) picks the pool whenever it is already
    busy or >= 2 fusable requests arrived in the same wave, and the
    singleton loop otherwise.  Non-fusable requests always route HOST.
    """

    MAX_LANES = 8
    SPREAD_THRESHOLD = 1.5

    def __init__(self, *, mode: Optional[Route] = None, window: int = 32,
                 cooldown: int = 32, pool_lanes: Optional[int] = None,
                 pool_ticks_per_sync: Optional[int] = None,
                 data_shards: int = 1, slo_native: bool = False):
        if mode is not None and not isinstance(mode, Route):
            raise TypeError(f"mode must be a Route or None; got {mode!r}")
        self.mode = mode
        # Phase J: with a degrade-armed pool behind the session, a fusable
        # request that CARRIES a deadline should always ride the pool --
        # only the pool can relax its epsilon or shed it with a pilot
        # answer; the singleton LOOP would just run it to completion and
        # miss.  Auto mode only (forced modes stay forced).
        self.slo_native = bool(slo_native)
        self.window = int(window)
        self.cooldown = int(cooldown)
        # Mesh-aware tier sizing (phase G): a sharded pool's per-tick
        # dispatch cost is near-constant in lane count at serving sample
        # sizes, so the lane ceiling scales with the mesh -- capacity
        # (lanes x resident rows) is what a data mesh buys.
        self.data_shards = max(int(data_shards), 1)
        self.pool_lanes = None if pool_lanes is None else int(pool_lanes)
        self.pool_ticks_per_sync = (
            None if pool_ticks_per_sync is None else int(pool_ticks_per_sync))
        # Sliding windows over the live stream.
        self._epsilons: Deque[float] = deque(maxlen=self.window)
        self._backlog: Deque[int] = deque(maxlen=self.window)
        self._since_rebuild = 0
        self.retunes = 0          # ticks_per_sync changes applied

    # -- routing ------------------------------------------------------------
    def route(self, request: Request, *, pending_fusable: int,
              pool_busy: bool, warm: bool = False) -> Route:
        """Pick the route for one request.

        ``pending_fusable`` is the number of fusable requests in the same
        admission wave (this request included); ``pool_busy`` whether the
        live pool currently holds in-flight or queued work.  ``warm``
        marks a warm-cache coefficient hit: it takes the WARM fast path
        (a warm-started pool lane) unless the operator forced a
        non-pool mode -- forced BATCHED/LOOP stay forced (compat).

        GROUP BY requests have exactly two homes: the pool's shared-scan
        lane block (phase I: one gather + one segment ESTIMATE per tick,
        whatever the group count) when the clause qualifies and the layout
        is single-device, else the host engine.  Forced BATCHED/LOOP modes
        do not apply -- those are solo-lane shapes.
        """
        if request.query.group_by:
            if not grouped_fusable(request) or self.data_shards > 1:
                return Route.HOST
            return Route.WARM if warm else Route.POOL
        if not fusable(request):
            return Route.HOST
        if warm and self.mode in (None, Route.POOL, Route.WARM):
            return Route.WARM
        if self.mode is not None:
            return self.mode
        # Auto: join a busy pool (mid-flight admission is the point of the
        # session API); build/use the pool for multi-request waves; serve
        # the cold singleton with one dispatch -- no pool to build, and a
        # solo closed loop beats pool ticking overhead.  Under slo_native
        # a deadline-carrying request routes POOL unconditionally: the
        # pool is where degradation and shedding live.
        if self.slo_native and request.deadline_s is not None:
            return Route.POOL
        if pool_busy or pending_fusable >= 2:
            return Route.POOL
        return Route.LOOP

    # -- observation --------------------------------------------------------
    def observe_request(self, request: Request) -> None:
        """Feed one admitted fusable request into the tuning window."""
        eps = request.query.epsilon
        if eps is not None:
            self._epsilons.append(float(eps))

    def observe_backlog(self, backlog: int) -> None:
        """Feed the fusable backlog (in-flight + waiting) of one admission
        wave."""
        if backlog > 0:
            self._backlog.append(int(backlog))

    def observe_completion(self, n: int = 1) -> None:
        self._since_rebuild += n

    # -- tuning -------------------------------------------------------------
    def _desired_lanes(self) -> int:
        if self.pool_lanes is not None:
            return self.pool_lanes
        k = max(self._backlog, default=1)
        max_lanes = self.MAX_LANES * self.data_shards
        lanes = max(2, min(max_lanes, (k + 1) // 2))
        lanes += lanes % 2          # even, so width tiers split cleanly
        return lanes

    def _desired_ticks_per_sync(self) -> int:
        if self.pool_ticks_per_sync is not None:
            return self.pool_ticks_per_sync
        if not self._epsilons:
            return 1
        spread = max(self._epsilons) / max(min(self._epsilons), 1e-9)
        return 1 if spread > self.SPREAD_THRESHOLD else 2

    def pool_plan(self, current_lanes: Optional[int] = None) -> PoolPlan:
        """The configuration the pool should run at, given the window.

        ``rebuild`` is only raised against a live pool (``current_lanes``)
        whose lane count drifted from the window's target, and only after
        ``cooldown`` completions since the last (re)build -- resizing means
        recompiling the step program, so it must be rare and idle-only.
        """
        lanes = self._desired_lanes()
        rebuild = (current_lanes is not None and lanes != current_lanes
                   and self._since_rebuild >= self.cooldown)
        return PoolPlan(lanes=lanes,
                        ticks_per_sync=self._desired_ticks_per_sync(),
                        rebuild=rebuild)

    def built_pool(self, lanes: int) -> None:
        """Record that the session (re)built the pool at ``lanes``."""
        del lanes
        self._since_rebuild = 0
