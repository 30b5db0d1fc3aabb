"""Asynchronous serving session in front of the lane pool.

* :meth:`AQPSession.submit` (``Request -> SessionTicket``) enqueues a request
  and returns at once.
* :meth:`pump` runs ONE scheduler round: admit arrivals (each routed by the
  :class:`~.planner.Planner`), tick the busy pool tiers once, harvest.  The
  pool accepts admissions while in flight.
* :meth:`poll` pops a finished response (None while in flight).
* :meth:`drain` pumps until idle.

Routes served here: POOL (continuous lanes, and GROUP BY requests as
grouped lane blocks of the same pool), BATCHED (one closed-loop dispatch per
func group), LOOP (one dispatch per query) and HOST: the host engine
(:class:`~repro_torch.aqp.engine.AQPEngine`) for everything the fused
program cannot run -- linf/l1/lp/diff/order metrics, relative bounds,
predicates, quantiles, min/max, regressions, and GROUP BY clauses a pool
block cannot serve.

With ``warm_cache`` on, each request is looked up at submit
(:class:`~.warm_cache.WarmCache`): a bit-identical repeat is answered from
the cache at ``poll()`` with zero dispatches and zero kernel launches; a
coefficient hit takes the WARM route, a pool lane (or GROUP BY block)
started from the cached prediction.  Degraded and shed answers, failed runs
and runs with a pinned key teach the cache nothing.

``degrade``/``wfq``/``tenant_weights``/``migrate`` arm the pool's overload
policies (:mod:`.slo`); with ``degrade`` the planner sends every
deadline-carrying fusable request to the pool, where it can be degraded or
shed.  Responses carry the delivered contract (``delivered_epsilon``,
``delivered_B``, ``degraded``, ``shed``).

``data_shards``/``mesh`` shard the pool (:class:`~.lane_pool.LanePool`);
the planner's lane ceiling scales with the shard count and every GROUP BY
request of a sharded session takes the HOST route.  Under a
:class:`~repro_torch.core.mesh.DataMesh` every rank runs the same session
on the same requests (SPMD), and with ``degrade`` the submit stamps a
deadline is measured from are rank 0's.

Sample reuse: one resident ``SampleStore`` per dataset, shared by the host
engine and every HOST request, and one ``sample_key`` per epoch pinning the
fused slot->row binding.  The epoch rotates after ``reshuffle_every``
completions (the store's permutations are redrawn with it), and a rotation
with pool tickets in flight is deferred to the pool's next idle point.
``rows_touched`` counts the store's gathered rows plus every fused lane's
filled watermark (at harvest).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np

from ..aqp.engine import AQPEngine
from ..aqp.query import Query, Request
from ..core import estimators
from ..core import keys as keylib
from ..core import trace
from ..core.fused import FINISH, PRE_READ, fused_l2miss_batch
from ..core.graphs import TickGraphs
from ..core.mesh import DataMesh
from ..core.sampling import GroupedData, SampleStore
from ..kernels import resolve_use_kernel
from .lane_pool import GroupPoolResponse, LanePool
from .planner import Planner, Route, fusable, grouped_fusable
from .warm_cache import CachedAnswer, WarmCache, WarmEntry


@dataclasses.dataclass(frozen=True)
class SessionTicket:
    """Handle returned by :meth:`AQPSession.submit`; poll with it."""
    rid: int                # the request's stable id
    submitted_s: float      # perf_counter at submission (the SLO clock 0)


@dataclasses.dataclass
class SessionResponse:
    """One finished request.  ``latency_s`` is the real submit -> completion
    time on every route; ``wall_time_s`` is the route's compute latency
    (real on POOL/LOOP, amortized dispatch/k on BATCHED)."""
    rid: int
    theta: np.ndarray
    error: float
    success: bool
    n: np.ndarray
    wall_time_s: float
    latency_s: float
    queue_wait_s: float
    route: Route
    rows_sampled: int
    deadline_s: Optional[float] = None
    slo_met: Optional[bool] = None      # None when no deadline was set
    epsilon: Optional[float] = None     # requested bound
    # The delivered contract under overload: a degraded answer ran at
    # ``delivered_epsilon > epsilon``, a shed one is an n_min pilot whose
    # delivered epsilon is its measured error; ``error <= delivered_epsilon``
    # either way, at the request's delta.
    delivered_epsilon: Optional[float] = None  # bound actually satisfied
    delivered_B: Optional[int] = None          # replicates actually run
    degraded: bool = False
    shed: bool = False
    # GROUP BY requests: ``theta``/``n`` hold one row per group,
    # ``error``/``success`` the summary (max over groups / the conjunction),
    # and the per-group quantiles and verdicts land here.
    group_by: bool = False
    group_error: Optional[np.ndarray] = None     # (G,)
    group_success: Optional[np.ndarray] = None   # (G,)
    # MISS's own iteration count (a GROUP BY answer: the most over its
    # groups; 0 for a cache replay or a shed answer) and the pool ticks from
    # splice to harvest (0 off the pool).
    iterations: int = 0
    ticks: int = 0


def _request_eps(q: Query) -> float:
    """The bound a cached answer is keyed on: the absolute epsilon, the
    relative one, or 1.0 for the parameterless order metric (the bound's
    kind is in the signature's shape, so the three never collide)."""
    if q.metric == "order":
        return 1.0
    if q.epsilon is not None:
        return float(q.epsilon)
    return float(q.epsilon_rel)


@dataclasses.dataclass
class _InFlight:
    ticket: SessionTicket
    request: Request
    key: Optional[np.ndarray]           # explicit bootstrap key, if any
    sig: Optional[tuple] = None         # cache signature (None: uncacheable)
    warm_n0: Optional[np.ndarray] = None    # predicted n* of a warm hit
    warm_beta: Optional[np.ndarray] = None  # its cached coefficients


class AQPSession:
    """Serve Listing-1 requests asynchronously against one resident
    GroupedData (on its device); ``data_shards``/``mesh`` as
    :class:`~.lane_pool.LanePool` takes them."""

    def __init__(self, data: GroupedData, *, B: int = 300,
                 n_min: int = 1000, n_max: int = 2000, max_iters: int = 24,
                 n_cap: int = 1 << 16, seed: int = 0,
                 reshuffle_every: int = 256,
                 use_kernel: "bool | str" = "auto",
                 planner: Optional[Planner] = None,
                 pool_tiers: "int | str" = "auto",
                 data_shards: int = 1, mesh=None,
                 warm_cache: "bool | WarmCache" = False,
                 degrade: bool = False, wfq: bool = False,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 migrate: bool = False, max_degrade: float = 8.0):
        self.data = data
        self.store = SampleStore(data, seed=seed)
        self.engine = AQPEngine(data, B=B, n_min=n_min, n_max=n_max,
                                seed=seed, store=self.store,
                                use_kernel=use_kernel)
        self.B, self.n_min, self.n_max = B, n_min, n_max
        self.max_iters, self.n_cap = max_iters, n_cap
        self.seed = seed
        self.use_kernel = resolve_use_kernel(use_kernel, data.device)
        self.degrade = bool(degrade)
        self.wfq = bool(wfq)
        self.tenant_weights = tenant_weights
        self.migrate = bool(migrate)
        self.max_degrade = float(max_degrade)
        # A data mesh multiplies pool capacity: the planner's lane ceiling
        # scales with it; the rest of the scheduler is unaware of it.
        self.data_shards = max(int(data_shards), 1)
        self.mesh = mesh
        self.planner = (planner if planner is not None
                        else Planner(data_shards=self.data_shards,
                                     slo_native=self.degrade))
        self.pool_tiers = pool_tiers
        self.key = keylib.prng_key(seed)
        self._m = data.num_groups
        self.reshuffle_every = int(reshuffle_every)
        self._queries_in_epoch = 0
        self._epoch_counter = 0
        self._sample_root = keylib.prng_key(seed ^ 0x5A17)
        self._sample_key = keylib.fold_in(self._sample_root, 0)
        self._arrivals: Deque[int] = deque()            # rids awaiting route
        self._inflight: Dict[int, _InFlight] = {}       # rid -> entry
        self._results: Dict[int, SessionResponse] = {}  # rid -> response
        self._pool: Optional[LanePool] = None
        self._pool_rids: Dict[int, int] = {}            # pool qid -> rid
        # The warm cache is opt-in: it changes how a repeat is served.
        if isinstance(warm_cache, WarmCache):
            self.cache: Optional[WarmCache] = warm_cache
        else:
            self.cache = WarmCache() if warm_cache else None
        self.warm_verify_failures = 0   # warm runs that needed > 1 iteration
        self.cache_served = 0           # exact-answer replays
        self._fused_rows = 0
        self.fused_dispatches = 0
        self.submitted = 0
        self.completed = 0
        self.pool_rebuilds = 0
        # CUDA graphs of the pool's tick before its host read and after its
        # moment sums: owned here, so a rebuilt pool replays the captures of
        # the last.
        self._graphs = TickGraphs()

    # -- public surface -----------------------------------------------------
    @property
    def rows_touched(self) -> int:
        """Cumulative rows sampled on every route: the store's gathers (host
        engine) plus every fused lane's filled watermark, counted at
        harvest."""
        return self.store.rows_touched + self._fused_rows

    @property
    def in_flight(self) -> int:
        """Requests submitted but not yet finished (queued or running)."""
        return len(self._inflight)

    def submit(self, request: Request, key=None) -> SessionTicket:
        """Enqueue one request (non-blocking; the next :meth:`pump` admits
        it).  ``key`` optionally pins the bootstrap key."""
        if not isinstance(request, Request):
            raise TypeError(
                f"submit() takes a Request (got {type(request).__name__}); "
                f"wrap the Query: Request(query=...)")
        if request.rid in self._inflight or request.rid in self._results:
            raise ValueError(f"request id {request.rid} already submitted")
        now = time.perf_counter()
        if self.degrade and isinstance(self.mesh, DataMesh):
            # The deadline clock of every rank: rank 0's.
            now = self.mesh.broadcast_float(now)
        ticket = SessionTicket(rid=request.rid, submitted_s=now)
        entry = _InFlight(ticket=ticket, request=request,
                          key=None if key is None else keylib.as_key(key))
        self._inflight[request.rid] = entry
        self.submitted += 1
        # A pinned key is a replay contract the cache must not alias.
        if self.cache is not None and entry.key is None \
                and self._cache_resolve(entry):
            return ticket       # exact replay: answered, zero dispatches
        self._arrivals.append(request.rid)
        return ticket

    def _cache_resolve(self, entry: _InFlight) -> bool:
        """Submit-time lookup.  True when the request was answered outright
        (a bit-identical repeat, replayed); otherwise a warm hit annotates
        the entry with its predicted ``n0`` and coefficients."""
        q = entry.request.query
        entry.sig = self.cache.signature(
            q, num_groups=self._m if q.group_by else None)
        if entry.sig is None:
            return False        # opaque callable predicate
        kind, ce = self.cache.lookup(entry.sig, epsilon=_request_eps(q))
        if kind == "exact":
            a = ce.answer
            self.cache_served += 1
            # No rows were sampled: the replay does not count toward the
            # reuse epoch.
            self._complete(
                entry, theta=a.theta.copy(), error=a.error,
                success=a.success, n=a.n.copy(), wall_time_s=0.0,
                queue_wait_s=0.0, route=Route.WARM, rows_sampled=0,
                count_epoch=False,
                group_error=None if a.group_error is None
                else a.group_error.copy(),
                group_success=None if a.group_success is None
                else a.group_success.copy())
            return True
        if kind == "warm" and (fusable(entry.request)
                               or grouped_fusable(entry.request)):
            entry.warm_n0 = self.cache.predict_n0(
                ce, epsilon=float(q.epsilon), n_min=self.n_min)
            entry.warm_beta = np.asarray(ce.beta, np.float32).copy()
        return False

    def _cache_insert(self, entry: _InFlight, *, beta, n, theta, error,
                      success: bool, failed: bool, iterations: int,
                      group_error=None, group_success=None) -> None:
        """Teach the cache one completed run.  Skipped for pinned-key runs
        (no signature), failed or unsuccessful runs, and runs whose
        signature predates the current epoch (a rotation fired while they
        were in flight)."""
        if (self.cache is None or entry.sig is None or failed
                or not success or entry.sig[0][0] != self.cache.epoch):
            return
        n = np.asarray(n)
        b = (np.zeros(n.shape[0] + 1, np.float32) if beta is None
             else np.asarray(beta, np.float32).copy())
        eps = _request_eps(entry.request.query)
        self.cache.insert(entry.sig, WarmEntry(
            beta=b, n_star=n.copy(), iterations=int(iterations), epsilon=eps,
            answer=CachedAnswer(
                theta=np.asarray(theta).copy(), error=float(error),
                success=True, n=n.copy(), epsilon=eps,
                group_error=None if group_error is None
                else np.asarray(group_error).copy(),
                group_success=None if group_success is None
                else np.asarray(group_success).copy())))

    def poll(self, ticket: Union[SessionTicket, int]
             ) -> Optional[SessionResponse]:
        """Pop the finished response for ``ticket``, or None while it is
        still in flight.  Unknown (or already-collected) tickets raise."""
        rid = ticket.rid if isinstance(ticket, SessionTicket) else int(ticket)
        if rid in self._results:
            return self._results.pop(rid)
        if rid in self._inflight:
            return None
        raise KeyError(f"unknown or already-collected ticket: rid={rid}")

    def pump(self) -> int:
        """One scheduler round: re-tune, admit arrivals, tick busy tiers
        once, harvest.  Returns requests in flight."""
        with trace.span("session.pump"):
            with trace.span("session.retune"):
                self._retune()
            with trace.span("session.admit"):
                self._admit()
            pool = self._pool
            if pool is not None and (pool.busy_lanes or pool.busy_blocks
                                     or pool.queue_depth):
                d0 = pool.dispatches
                pool.tick()
                self.fused_dispatches += pool.dispatches - d0
            with trace.span("session.harvest"):
                self._harvest_pool()
            return self.in_flight

    def drain(self, max_pumps: int = 100_000) -> List[SessionResponse]:
        """Pump until nothing is in flight; pop and return every finished
        response not yet polled, in rid order."""
        guard = 0
        while self._inflight and guard < max_pumps:
            self.pump()
            guard += 1
        return [self._results.pop(rid) for rid in sorted(self._results)]

    def refresh(self, data: Optional[GroupedData] = None) -> None:
        """Invalidate resident samples after a data update (idle only)."""
        if self._inflight:
            raise RuntimeError(
                "cannot refresh() with requests in flight; drain() first")
        if data is not None:
            self.data = data
            self.engine.data = data
            self._m = data.num_groups
        self.engine.refresh(self.data)
        self._pool = None               # resident prefixes follow the data
        self._rotate_epoch()

    def stats(self) -> Dict[str, object]:
        out = {
            "submitted": self.submitted,
            "completed": self.completed,
            "in_flight": self.in_flight,
            "fused_dispatches": self.fused_dispatches,
            "rows_touched": self.rows_touched,
            "store_rows": self.store.rows_touched,
            "fused_rows": self._fused_rows,
            "pool_rebuilds": self.pool_rebuilds,
            "graph_captures": self._graphs.captures[PRE_READ],
            "graph_replays": self._graphs.replays[PRE_READ],
            "eager_pre_read": self._graphs.eager[PRE_READ],
            "finish_captures": self._graphs.captures[FINISH],
            "finish_replays": self._graphs.replays[FINISH],
            "eager_finish": self._graphs.eager[FINISH],
            "sample_epoch": self._epoch_counter,
        }
        if self.cache is not None:
            out["cache_hits"] = self.cache.hits
            out["cache_misses"] = self.cache.misses
            out["cache_evictions"] = self.cache.evictions
            out["cache_served"] = self.cache_served
            out["warm_verify_failures"] = self.warm_verify_failures
            out["warm_cache"] = self.cache.stats()
        if self._pool is not None:
            out["pool"] = self._pool.stats()
        return out

    # -- epoch policy -------------------------------------------------------
    def _rotate_epoch(self) -> None:
        self._epoch_counter += 1
        self._queries_in_epoch = 0
        self._sample_key = keylib.fold_in(self._sample_root,
                                          self._epoch_counter)
        if self.cache is not None:
            # Entries were learned under the old slot->row binding; the new
            # epoch also keeps in-flight runs of the old one from inserting.
            self.cache.rotate_epoch()
        if self._pool is not None:
            # Deferred: applied now if the pool is idle, else at its next
            # idle point -- never under a resident prefix.
            self._pool.request_sample_key(self._sample_key)

    def _complete(self, entry: _InFlight, *, theta, error, success, n,
                  wall_time_s: float, queue_wait_s: float, route: Route,
                  rows_sampled: int, now: Optional[float] = None,
                  count_epoch: bool = True, group_error=None,
                  group_success=None, delivered_epsilon=None,
                  delivered_B=None, degraded: bool = False,
                  shed: bool = False, iterations: int = 0,
                  ticks: int = 0) -> None:
        now = time.perf_counter() if now is None else now
        latency = now - entry.ticket.submitted_s
        ddl = entry.request.deadline_s
        self._results[entry.request.rid] = SessionResponse(
            rid=entry.request.rid, theta=theta, error=error, success=success,
            n=n, wall_time_s=wall_time_s, latency_s=latency,
            queue_wait_s=queue_wait_s, route=route,
            rows_sampled=rows_sampled, deadline_s=ddl,
            slo_met=None if ddl is None else latency <= ddl,
            epsilon=entry.request.query.epsilon,
            delivered_epsilon=delivered_epsilon, delivered_B=delivered_B,
            degraded=degraded, shed=shed,
            group_by=bool(entry.request.query.group_by),
            group_error=group_error, group_success=group_success,
            iterations=iterations, ticks=ticks)
        del self._inflight[entry.request.rid]
        self.completed += 1
        if not count_epoch:
            return          # a cache replay sampled nothing
        self.planner.observe_completion()
        self._queries_in_epoch += 1
        if self._queries_in_epoch >= self.reshuffle_every:
            self.store.reshuffle()
            self._rotate_epoch()

    # -- pool management ----------------------------------------------------
    def _build_pool(self, lanes: int, ticks_per_sync: int) -> LanePool:
        pool = LanePool(
            self.data, lanes=lanes, B=self.B, n_min=self.n_min,
            n_max=self.n_max, max_iters=self.max_iters, n_cap=self.n_cap,
            use_kernel=self.use_kernel, seed=self.seed,
            sample_key=self._sample_key, ticks_per_sync=ticks_per_sync,
            tiers=self.pool_tiers, data_shards=self.data_shards,
            mesh=self.mesh, degrade=self.degrade, wfq=self.wfq,
            tenant_weights=self.tenant_weights, migrate=self.migrate,
            max_degrade=self.max_degrade, graphs=self._graphs)
        self.planner.built_pool(lanes)
        return pool

    def _ensure_pool(self) -> LanePool:
        if self._pool is None:
            plan = self.planner.pool_plan()
            self._pool = self._build_pool(plan.lanes, plan.ticks_per_sync)
        return self._pool

    def _retune(self) -> None:
        """The planner's sliding-window policy on the live pool: cadence
        between any two dispatches, lane-count rebuilds at idle points."""
        pool = self._pool
        if pool is None:
            return
        plan = self.planner.pool_plan(current_lanes=pool.lanes)
        if plan.ticks_per_sync != pool.ticks_per_sync:
            pool.ticks_per_sync = plan.ticks_per_sync
            self.planner.retunes += 1
        if (plan.rebuild and not pool.busy_lanes and not pool.busy_blocks
                and not pool.queue_depth and not pool.results):
            self._pool = self._build_pool(plan.lanes, plan.ticks_per_sync)
            self.pool_rebuilds += 1

    # -- admission ----------------------------------------------------------
    def _admit(self) -> None:
        """Route every queued arrival; BATCHED/LOOP complete inside this
        call, POOL submissions ride subsequent pumps."""
        if not self._arrivals:
            return
        wave = [self._inflight[rid] for rid in self._arrivals]
        self._arrivals.clear()
        pool = self._pool
        pool_busy = pool is not None and bool(
            pool.busy_lanes or pool.busy_blocks or pool.queue_depth)
        # Warm hits are short-lived lanes: kept out of the planner's tuning
        # windows, so a burst of repeats does not trigger pool rebuilds.
        n_fus = 0
        for e in wave:
            if fusable(e.request) and e.warm_n0 is None:
                n_fus += 1
                self.planner.observe_request(e.request)
        self.planner.observe_backlog(
            n_fus + ((pool.busy_lanes + pool.queue_depth) if pool else 0))
        groups: Dict[Route, List[_InFlight]] = {}
        for e in wave:
            route = self.planner.route(
                e.request, pending_fusable=n_fus, pool_busy=pool_busy,
                warm=e.warm_n0 is not None)
            groups.setdefault(route, []).append(e)
        try:
            # WARM rides the pool: a warm lane or block.
            pooled = groups.get(Route.POOL, []) + groups.get(Route.WARM, [])
            if pooled:
                self._admit_pool(pooled)
            if Route.BATCHED in groups:
                with trace.span("session.batched"):
                    self._run_batched(groups[Route.BATCHED])
            if Route.LOOP in groups:
                with trace.span("session.loop"):
                    self._run_loop(groups[Route.LOOP])
            for e in groups.get(Route.HOST, ()):
                self._run_host(e)
        except BaseException:
            # Re-queue entries neither completed nor handed to the pool, so
            # the next pump retries them (a failing request keeps raising to
            # its caller rather than vanishing).
            pooled = set(self._pool_rids.values())
            stranded = [e.request.rid for e in wave
                        if e.request.rid in self._inflight
                        and e.request.rid not in pooled]
            self._arrivals.extendleft(reversed(stranded))
            raise

    # Admission-wave key splits round up to a power of two, as the
    # reference does, so the same requests draw the same keys.
    _KEY_BUCKETS = (2, 4, 8, 16, 32, 64)

    def _lane_keys(self, entries: List[_InFlight]) -> List[np.ndarray]:
        """Per-entry bootstrap keys from ONE split of the session key, with
        explicitly pinned keys taking their slot."""
        n = len(entries)
        m = next((b for b in self._KEY_BUCKETS if b > n), n + 1)
        ks = keylib.split(self.key, m)
        self.key = ks[0]
        return [k if e.key is None else e.key
                for e, k in zip(entries, ks[1:n + 1])]

    def _admit_pool(self, entries: List[_InFlight]) -> None:
        pool = self._ensure_pool()
        for e, key in zip(entries, self._lane_keys(entries)):
            req = e.request
            if req.query.group_by:
                # A grouped request is admitted at once as a lane block: no
                # ticket queue, no priority/deadline reorder.
                qid = pool.submit_group(req.query, key=key,
                                        warm_n0=e.warm_n0,
                                        warm_beta=e.warm_beta)
            else:
                deadline_at = (None if req.deadline_s is None
                               else e.ticket.submitted_s + req.deadline_s)
                qid = pool.submit(req.query, key=key, priority=req.priority,
                                  deadline_at=deadline_at, warm_n0=e.warm_n0,
                                  warm_beta=e.warm_beta, tenant=req.tenant)
            self._pool_rids[qid] = req.rid

    def _harvest_pool(self) -> None:
        pool = self._pool
        if pool is None or not pool.results:
            return
        now = time.perf_counter()
        for qid in sorted(pool.results):
            r = pool.results.pop(qid)
            self._fused_rows += r.rows_sampled
            rid = self._pool_rids.pop(qid, None)
            if rid is None:
                continue        # foreign ticket (pool shared out-of-band)
            entry = self._inflight[rid]
            warm = entry.warm_n0 is not None
            grouped = isinstance(r, GroupPoolResponse)
            degraded = not grouped and r.degraded
            shed = not grouped and r.shed
            its = int(np.max(r.iterations)) if grouped else int(r.iterations)
            if warm and not shed and its > 1:
                # The prediction did not verify in one tick; the lane fell
                # through to the extend loop (still correct).
                self.warm_verify_failures += 1
            err = float(np.max(r.error)) if grouped else float(r.error)
            if not (degraded or shed):
                # A degraded run met only the relaxed bound, a shed one only
                # its pilot's: neither may answer the requested epsilon.
                self._cache_insert(
                    entry, beta=r.beta, n=r.n, theta=r.theta, error=err,
                    success=bool(r.success), failed=bool(r.failed),
                    iterations=its,
                    group_error=r.error if grouped else None,
                    group_success=r.group_success if grouped else None)
            wall = now - entry.ticket.submitted_s
            resident = r.wall_time_s - r.queue_wait_s
            self._complete(
                entry, theta=r.theta, error=err, success=bool(r.success),
                n=r.n, wall_time_s=wall,
                queue_wait_s=max(wall - resident, 0.0),
                route=Route.WARM if warm else Route.POOL,
                rows_sampled=r.rows_sampled, now=now,
                group_error=r.error if grouped else None,
                group_success=r.group_success if grouped else None,
                delivered_epsilon=None if grouped else r.delivered_epsilon,
                delivered_B=None if grouped else r.delivered_B,
                degraded=degraded, shed=shed, iterations=its,
                ticks=r.ticks_in_block if grouped else r.ticks_in_lane)

    # -- synchronous routes -------------------------------------------------
    def _dispatch_fused(self, func: str, queries: List[Query], keys):
        """One batched fused run for ``len(queries)`` same-func lanes."""
        k = len(queries)
        row = estimators.population_scale_row(func, self.data.scale)
        res = fused_l2miss_batch(
            self.data.values, self.data.offsets,
            np.broadcast_to(row, (k, self._m)), np.stack(keys),
            np.asarray([q.epsilon for q in queries], np.float32),
            np.asarray([q.delta for q in queries], np.float32),
            sample_keys=self._sample_key, est_name=func, B=self.B,
            n_min=self.n_min, n_max=self.n_max, l=min(self._m + 2, 12),
            max_iters=self.max_iters, n_cap=self.n_cap,
            use_kernel=self.use_kernel)
        self.fused_dispatches += 1
        return res

    def _by_func(self, entries: List[_InFlight]
                 ) -> List[Tuple[str, List[_InFlight]]]:
        by_func: Dict[str, List[_InFlight]] = {}
        for e in entries:
            by_func.setdefault(e.request.query.func, []).append(e)
        return list(by_func.items())

    def _finish_fused(self, group: List[_InFlight], res, route: Route,
                      wall_s) -> None:
        theta, err = res.theta.cpu().numpy(), res.error.cpu().numpy()
        succ, ns = res.success.cpu().numpy(), res.n.cpu().numpy()
        rows = res.rows_sampled.cpu().numpy()
        betas, fails = res.beta.cpu().numpy(), res.failed.cpu().numpy()
        its = res.iterations.cpu().numpy()
        for lane, e in enumerate(group):
            self._fused_rows += int(rows[lane])
            self._cache_insert(
                e, beta=betas[lane], n=ns[lane], theta=theta[lane],
                error=float(err[lane]), success=bool(succ[lane]),
                failed=bool(fails[lane]), iterations=int(its[lane]))
            self._complete(
                e, theta=theta[lane], error=float(err[lane]),
                success=bool(succ[lane]), n=ns[lane],
                wall_time_s=wall_s(), queue_wait_s=0.0, route=route,
                rows_sampled=int(rows[lane]), iterations=int(its[lane]))

    def _run_batched(self, entries: List[_InFlight]) -> None:
        """Closed-loop batching: ONE dispatch per func group, amortized
        per-query wall time."""
        for func, group in self._by_func(entries):
            keys = self._lane_keys(group)
            t0 = time.perf_counter()
            res = self._dispatch_fused(
                func, [e.request.query for e in group], keys)
            per_q = (time.perf_counter() - t0) / len(group)
            self._finish_fused(group, res, Route.BATCHED, lambda: per_q)

    def _run_loop(self, entries: List[_InFlight]) -> None:
        """Per-query dispatch loop: k dispatches, timed individually."""
        for func, group in self._by_func(entries):
            keys = self._lane_keys(group)
            for e, key in zip(group, keys):
                t0 = time.perf_counter()
                res = self._dispatch_fused(func, [e.request.query], [key])
                self._finish_fused([e], res, Route.LOOP,
                                   lambda: time.perf_counter() - t0)

    def _run_host(self, entry: _InFlight) -> None:
        """The host engine: metrics, bounds, predicates and functions the
        fused program cannot run; grouped clauses a pool block cannot serve
        (predicates, relative bounds, any clause of a sharded session)."""
        t0 = time.perf_counter()
        if entry.request.query.group_by:
            return self._run_host_grouped(entry, t0)
        tr = self.engine.execute(entry.request.query)
        beta = tr.info.get("beta") if isinstance(tr.info, dict) else None
        self._cache_insert(
            entry, beta=beta, n=tr.n, theta=tr.theta, error=tr.error,
            success=bool(tr.success), failed=tr.status == "unrecoverable",
            iterations=int(tr.iterations))
        self._complete(
            entry, theta=tr.theta, error=tr.error, success=tr.success,
            n=tr.n, wall_time_s=time.perf_counter() - t0, queue_wait_s=0.0,
            route=Route.HOST, rows_sampled=0, iterations=int(tr.iterations))

    def _run_host_grouped(self, entry: _InFlight, t0: float) -> None:
        """``AQPEngine.execute_grouped``: the shared-scan block program,
        dispatched synchronously outside the pool."""
        res = self.engine.execute(entry.request.query)
        theta = res.theta.cpu().numpy()[:, 0]
        gerr, gok = res.error.cpu().numpy(), res.success.cpu().numpy()
        rows = int(res.rows_sampled.sum())
        self._fused_rows += rows
        self.fused_dispatches += 1
        n = res.n.cpu().numpy()
        its = int(res.iterations.max())
        self._cache_insert(
            entry, beta=res.beta.cpu().numpy(), n=n, theta=theta,
            error=float(gerr.max()), success=bool(gok.all()),
            failed=bool(res.failed.cpu().numpy().any()), iterations=its,
            group_error=gerr, group_success=gok)
        self._complete(
            entry, theta=theta, error=float(gerr.max()),
            success=bool(gok.all()), n=n,
            wall_time_s=time.perf_counter() - t0, queue_wait_s=0.0,
            route=Route.HOST, rows_sampled=rows,
            group_error=gerr, group_success=gok, iterations=its)
