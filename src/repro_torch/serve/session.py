"""Asynchronous serving session in front of the lane pool.

* :meth:`AQPSession.submit` (``Request -> SessionTicket``) enqueues a request
  and returns at once.
* :meth:`pump` runs ONE scheduler round: admit arrivals (each routed by the
  :class:`~.planner.Planner`), tick the busy pool tiers once, harvest.  The
  pool accepts admissions while in flight.
* :meth:`poll` pops a finished response (None while in flight).
* :meth:`drain` pumps until idle.

Routes served here: POOL (continuous lanes), BATCHED (one closed-loop
dispatch per func group) and LOOP (one dispatch per query).  HOST, WARM and
GROUP BY requests belong to later slices and raise ``NotImplementedError``.

One ``sample_key`` per epoch pins the fused slot->row binding; the epoch
rotates after ``reshuffle_every`` completions, and a rotation with pool
tickets in flight is deferred to the pool's next idle point.  The port has
no host engine or ``SampleStore`` yet, so ``rows_touched`` counts the fused
rows only (every lane's filled watermark, at harvest).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

import numpy as np

from ..aqp.query import Query, Request
from ..core import estimators
from ..core import keys as keylib
from ..core.fused import fused_l2miss_batch
from ..core.sampling import GroupedData
from ..kernels import resolve_use_kernel
from .lane_pool import LanePool
from .planner import Planner, Route, fusable


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


@dataclasses.dataclass
class _InFlight:
    ticket: SessionTicket
    request: Request
    key: Optional[np.ndarray]           # explicit bootstrap key, if any


def _later(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue 1)")


class AQPSession:
    """Serve Listing-1 requests asynchronously against one resident
    GroupedData (on its device)."""

    def __init__(self, data: GroupedData, *, B: int = 300,
                 n_min: int = 1000, n_max: int = 2000, max_iters: int = 24,
                 n_cap: int = 1 << 16, seed: int = 0,
                 reshuffle_every: int = 256,
                 use_kernel: "bool | str" = "auto",
                 planner: Optional[Planner] = None,
                 pool_tiers: "int | str" = "auto",
                 data_shards: int = 1, mesh=None,
                 warm_cache=False, degrade: bool = False, wfq: bool = False,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 migrate: bool = False, max_degrade: float = 8.0):
        if warm_cache:
            raise _later("the warm cache (item 11)")
        if data_shards != 1 or mesh is not None:
            raise _later("the sharded pool (item 14)")
        if degrade or wfq or tenant_weights is not None or migrate:
            raise _later("SLO scheduling (item 12)")
        del max_degrade
        self.data = data
        self.B, self.n_min, self.n_max = B, n_min, n_max
        self.max_iters, self.n_cap = max_iters, n_cap
        self.seed = seed
        self.use_kernel = resolve_use_kernel(use_kernel, data.device)
        self.planner = planner if planner is not None else Planner()
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
        self._fused_rows = 0
        self.fused_dispatches = 0
        self.submitted = 0
        self.completed = 0
        self.pool_rebuilds = 0

    # -- public surface -----------------------------------------------------
    @property
    def rows_touched(self) -> int:
        """Cumulative rows sampled by fused lanes (filled watermarks),
        counted at harvest."""
        return self._fused_rows

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
        ticket = SessionTicket(rid=request.rid,
                               submitted_s=time.perf_counter())
        self._inflight[request.rid] = _InFlight(
            ticket=ticket, request=request,
            key=None if key is None else keylib.as_key(key))
        self.submitted += 1
        self._arrivals.append(request.rid)
        return ticket

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
        self._retune()
        self._admit()
        pool = self._pool
        if pool is not None and (pool.busy_lanes or pool.queue_depth):
            d0 = pool.dispatches
            pool.tick()
            self.fused_dispatches += pool.dispatches - d0
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

    def stats(self) -> Dict[str, object]:
        out = {
            "submitted": self.submitted,
            "completed": self.completed,
            "in_flight": self.in_flight,
            "fused_dispatches": self.fused_dispatches,
            "rows_touched": self.rows_touched,
            "pool_rebuilds": self.pool_rebuilds,
            "sample_epoch": self._epoch_counter,
        }
        if self._pool is not None:
            out["pool"] = self._pool.stats()
        return out

    # -- epoch policy -------------------------------------------------------
    def _rotate_epoch(self) -> None:
        self._epoch_counter += 1
        self._queries_in_epoch = 0
        self._sample_key = keylib.fold_in(self._sample_root,
                                          self._epoch_counter)
        if self._pool is not None:
            # Deferred: applied now if the pool is idle, else at its next
            # idle point -- never under a resident prefix.
            self._pool.request_sample_key(self._sample_key)

    def _complete(self, entry: _InFlight, *, theta, error, success, n,
                  wall_time_s: float, queue_wait_s: float, route: Route,
                  rows_sampled: int, now: Optional[float] = None) -> None:
        now = time.perf_counter() if now is None else now
        latency = now - entry.ticket.submitted_s
        ddl = entry.request.deadline_s
        self._results[entry.request.rid] = SessionResponse(
            rid=entry.request.rid, theta=theta, error=error, success=success,
            n=n, wall_time_s=wall_time_s, latency_s=latency,
            queue_wait_s=queue_wait_s, route=route,
            rows_sampled=rows_sampled, deadline_s=ddl,
            slo_met=None if ddl is None else latency <= ddl,
            epsilon=entry.request.query.epsilon)
        del self._inflight[entry.request.rid]
        self.completed += 1
        self.planner.observe_completion()
        self._queries_in_epoch += 1
        if self._queries_in_epoch >= self.reshuffle_every:
            self._rotate_epoch()

    # -- pool management ----------------------------------------------------
    def _build_pool(self, lanes: int, ticks_per_sync: int) -> LanePool:
        pool = LanePool(
            self.data, lanes=lanes, B=self.B, n_min=self.n_min,
            n_max=self.n_max, max_iters=self.max_iters, n_cap=self.n_cap,
            use_kernel=self.use_kernel, seed=self.seed,
            sample_key=self._sample_key, ticks_per_sync=ticks_per_sync,
            tiers=self.pool_tiers)
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
        if (plan.rebuild and not pool.busy_lanes and not pool.queue_depth
                and not pool.results):
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
        pool_busy = pool is not None and bool(pool.busy_lanes
                                              or pool.queue_depth)
        n_fus = 0
        for e in wave:
            if fusable(e.request):
                n_fus += 1
                self.planner.observe_request(e.request)
        self.planner.observe_backlog(
            n_fus + ((pool.busy_lanes + pool.queue_depth) if pool else 0))
        groups: Dict[Route, List[_InFlight]] = {}
        for e in wave:
            route = self.planner.route(
                e.request, pending_fusable=n_fus, pool_busy=pool_busy)
            groups.setdefault(route, []).append(e)
        try:
            if Route.HOST in groups:
                raise _later("the host route (item 10)")
            if Route.POOL in groups:
                if any(e.request.query.group_by for e in groups[Route.POOL]):
                    raise _later("GROUP BY lane blocks (item 13)")
                self._admit_pool(groups[Route.POOL])
            if Route.BATCHED in groups:
                self._run_batched(groups[Route.BATCHED])
            if Route.LOOP in groups:
                self._run_loop(groups[Route.LOOP])
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
            deadline_at = (None if req.deadline_s is None
                           else e.ticket.submitted_s + req.deadline_s)
            qid = pool.submit(req.query, key=key, priority=req.priority,
                              deadline_at=deadline_at)
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
            wall = now - entry.ticket.submitted_s
            resident = r.wall_time_s - r.queue_wait_s
            self._complete(
                entry, theta=r.theta, error=float(r.error),
                success=bool(r.success), n=r.n, wall_time_s=wall,
                queue_wait_s=max(wall - resident, 0.0), route=Route.POOL,
                rows_sampled=r.rows_sampled, now=now)

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
        for lane, e in enumerate(group):
            self._fused_rows += int(rows[lane])
            self._complete(
                e, theta=theta[lane], error=float(err[lane]),
                success=bool(succ[lane]), n=ns[lane],
                wall_time_s=wall_s(), queue_wait_s=0.0, route=route,
                rows_sampled=int(rows[lane]))

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
