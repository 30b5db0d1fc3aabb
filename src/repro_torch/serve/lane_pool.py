"""Continuous lane-pool AQP serving on the card.

A FIXED pool of ``lanes`` query lanes is ticked from the host through the
resumable :func:`~repro_torch.core.fused.fused_step`; between ticks
converged lanes are RETIRED (answer harvested) and REFILLED by splicing a
waiting query's (scale, key, epsilon, delta, estimator) into the freed lane.

Why retire/refill preserves trajectories: a lane's tick counter ``k`` is
per-lane state and the splice resets it to 0; its bootstrap stream is
``hash3(boot_base(key), k, group)``, a function of its own key and age; the
slot->row binding is the pool-shared ``sample_key`` table; and the ESTIMATE
width bucket is compute width only.  So a pool-served query answers exactly
as a solo ``fused_l2miss`` run with the same (key, sample_key).

Width-aware admission: the lanes are split into ``tiers`` equal sub-pools,
each with its own state and one step dispatch per tick, and a waiting query
goes to the free-laned tier with the smallest active watermark.

Lanes pick their estimator per lane by moment-family index, so
avg/sum/count/std/var/proportion queries share one pool.  SUM/COUNT lanes
carry their population scale in their scale row.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..aqp.query import Query
from ..core import estimators
from ..core import keys as keylib
from ..core.fused import (LaneParams, LaneState, fused_step,
                          init_lane_state, lane_boot_seed, make_lane_params,
                          resolve_ext_cap)
from ..core.sampling import GroupedData, counter_slot_table
from ..kernels import resolve_use_kernel


@dataclasses.dataclass
class PoolResponse:
    """One retired query: the answer plus the pool's latency accounting."""
    qid: int
    func: str
    theta: np.ndarray       # (m, 1) scaled estimate
    error: float
    success: bool           # error bound met
    failed: bool            # Algorithm-2 unrecoverable failure
    n: np.ndarray           # (m,) final sizes
    iterations: int
    rows_sampled: int       # final filled watermark (shared-prefix rows)
    wall_time_s: float      # submit -> harvest
    queue_wait_s: float     # submit -> splice
    ticks_in_lane: int      # loop ticks while resident
    lane: int               # global lane id (tier * tier_lanes + local)
    tier: int               # width tier the query rode in
    spliced_tier_width: int  # tier's max active watermark at splice time
    beta: Optional[np.ndarray] = None   # (m+1,) final fitted coefficients


@dataclasses.dataclass
class _Ticket:
    qid: int
    func: str
    fid: int
    epsilon: float
    delta: float
    key: np.ndarray                         # (2,) uint32 bootstrap key
    scale_row: np.ndarray
    submitted_s: float
    priority: int = 0                       # higher = admitted first
    deadline_at: Optional[float] = None     # absolute perf_counter deadline
    spliced_s: float = 0.0
    spliced_tick: int = 0
    spliced_width: int = 0

    @property
    def order(self):
        """Admission order: priority class first, then earliest deadline,
        then FIFO.  The reference's weighted-fair virtual finish time sits
        between priority and deadline; without fair queueing it is 0 for
        every ticket.  Order changes WHEN a query is spliced, never its
        trajectory."""
        ddl = self.deadline_at if self.deadline_at is not None else np.inf
        return (-self.priority, 0.0, ddl, self.qid)


@dataclasses.dataclass
class _Tier:
    """One width tier: its own carry/params and occupancy bookkeeping."""
    state: LaneState
    params: LaneParams
    occupant: List[Optional[_Ticket]]
    filled_host: np.ndarray     # (tier_lanes, m) watermarks at last sync

    @property
    def busy(self) -> int:
        return sum(t is not None for t in self.occupant)

    @property
    def width(self) -> int:
        """Max watermark over OCCUPIED lanes (host view, lags one sync)."""
        occ = [i for i, t in enumerate(self.occupant) if t is not None]
        return int(self.filled_host[occ].max()) if occ else 0


def _splice(state: LaneState, params: LaneParams, lanes: List[int],
            keys: np.ndarray, scale_rows: np.ndarray, eps: np.ndarray,
            deltas: np.ndarray, fids: np.ndarray, *, n_min: int) -> None:
    """Reset ``lanes`` to tick 0 IN PLACE, swapping in their new queries --
    row for row what ``init_lane_state``/``make_lane_params`` build, so a
    refilled lane is indistinguishable from a lane of a fresh pool."""
    dev = state.k.device
    li = torch.as_tensor(lanes, dtype=torch.int64, device=dev)
    put = lambda t, v: t.index_put_((li,), torch.as_tensor(v, device=dev))
    state.keys[li] = torch.as_tensor(keys.astype(np.int64), device=dev)
    state.k[li] = 0
    state.iters[li] = 0
    state.n_cur[li] = n_min
    state.filled[li] = 0
    state.buf[li] = 0.0
    state.prof_n[li] = 1.0
    state.prof_loge[li] = 0.0
    state.e[li] = float("inf")
    state.theta[li] = 0.0
    state.done[li] = False
    state.failed[li] = False
    state.beta[li] = 0.0
    state.r2[li] = 0.0
    put(params.scale, scale_rows.astype(np.float32))
    put(params.epsilons, eps.astype(np.float32))
    put(params.deltas, deltas.astype(np.float32))
    put(params.est_fids, fids.astype(np.int32))
    put(params.boot_base,
        np.asarray([lane_boot_seed(k) for k in keys], np.int64))


def _later(item: str):
    return NotImplementedError(f"not ported yet: ROADMAP Queue 1 item {item}")


class LanePool:
    """A fixed pool of query lanes with width-aware admission and
    retire-and-refill.  ``ticks_per_sync`` trades host round-trips against
    refill granularity; ``tiers="auto"`` splits an even pool into two width
    tiers.  Arguments of later slices (sharding, SLO scheduling) raise."""

    def __init__(self, data: GroupedData, *, lanes: int = 4, B: int = 300,
                 n_min: int = 1000, n_max: int = 2000, max_iters: int = 24,
                 n_cap: int = 1 << 16, l: Optional[int] = None,
                 metric: str = "l2", growth_cap: float = 8.0,
                 ext_cap: Optional[int] = None,
                 use_kernel: "bool | str" = "auto", gate_gather: bool = True,
                 seed: int = 0, sample_key=None, ticks_per_sync: int = 1,
                 tiers: "int | str" = "auto", data_shards: int = 1,
                 mesh=None, degrade: bool = False, wfq: bool = False,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 migrate: bool = False, max_degrade: float = 8.0):
        if data_shards != 1 or mesh is not None:
            raise _later("14 (sharded pool)")
        if degrade or wfq or tenant_weights is not None or migrate:
            raise _later("12 (SLO scheduling: degrade, wfq, migrate)")
        del max_degrade
        self.data = data
        self.device = data.device
        self.lanes = int(lanes)
        if tiers == "auto":
            tiers = 2 if self.lanes >= 2 and self.lanes % 2 == 0 else 1
        self.tiers = int(tiers)
        if self.lanes % self.tiers:
            raise ValueError(
                f"lanes ({self.lanes}) must divide evenly into tiers "
                f"({self.tiers})")
        self.tier_lanes = self.lanes // self.tiers
        m = data.num_groups
        self._offsets = np.asarray(data.offsets)
        self._family = {e.name: i
                        for i, e in enumerate(estimators.moment_family())}
        self._values = data.values
        self._spec = dict(
            est_name=None, B=B, n_min=n_min, n_max=n_max,
            l=int(l if l is not None else min(m + 2, 12)), tau=1e-3,
            max_iters=max_iters, n_cap=n_cap, metric=metric,
            growth_cap=growth_cap,
            ext_cap=resolve_ext_cap(n_cap, n_max, ext_cap), adaptive=True,
            use_kernel=resolve_use_kernel(use_kernel, self.device),
            gate_gather=gate_gather)
        self.ticks_per_sync = int(ticks_per_sync)
        self.key = keylib.prng_key(seed)
        if sample_key is None:
            sample_key = keylib.prng_key(seed ^ 0x5A17)
        self._sample_key = keylib.as_key(sample_key)
        keys0 = keylib.split(keylib.prng_key(seed), self.lanes)
        tl = self.tier_lanes
        self._tiers: List[_Tier] = []
        for ti in range(self.tiers):
            tkeys = keys0[ti * tl:(ti + 1) * tl]
            params = make_lane_params(
                self._offsets, np.ones((tl, m), np.float32), tkeys,
                np.ones((tl,), np.float32), np.full((tl,), 0.05, np.float32),
                self._sample_key, np.zeros((tl,), np.int32), n_cap=n_cap,
                device=self.device)
            state = init_lane_state(
                tkeys, m, n_cap=n_cap, c_dim=data.values.shape[1], p_dim=1,
                n_min=n_min, max_iters=max_iters, device=self.device,
                dtype=data.values.dtype)
            # Empty lanes are parked as ``done``: the step freezes them
            # (gated bootstrap and gated gather) until a splice.
            state.done.fill_(True)
            self._tiers.append(_Tier(
                state=state, params=params, occupant=[None] * tl,
                filled_host=np.zeros((tl, m), np.int64)))
        self._queue: Deque[_Ticket] = deque()
        self._pending_sample_key: Optional[np.ndarray] = None
        self.sample_epochs = 0
        self._scale_rows: Dict[str, np.ndarray] = {}
        # Hand-off buffer: harvest fills it, drain() pops it.
        self.results: Dict[int, PoolResponse] = {}
        self._next_qid = 0
        self.ticks = 0            # scheduling rounds executed
        self.dispatches = 0       # step launches (tier syncs)
        self.lane_ticks_busy = 0  # occupied-lane ticks (occupancy integral)
        self.submitted = 0
        self.retired = 0
        self.peak_queue_depth = 0
        self._active_frac_sum = 0.0
        self._retired_rows = 0

    # -- admission ----------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def busy_lanes(self) -> int:
        return sum(t.busy for t in self._tiers)

    def supports(self, query: Query) -> bool:
        """Whether this pool can serve ``query`` (moment family, this
        metric, absolute bound, no predicate, no GROUP BY)."""
        return (query.func in self._family
                and query.metric == self._spec["metric"]
                and query.epsilon is not None
                and query.predicate is None and not query.group_by)

    def submit(self, query: Query, key=None, *, priority: int = 0,
               deadline_at: Optional[float] = None, warm_n0=None,
               warm_beta=None) -> int:
        """Enqueue one query; returns its qid (results keyed on it).
        ``priority``/``deadline_at`` (absolute ``time.perf_counter``) shape
        admission order only."""
        if warm_n0 is not None or warm_beta is not None:
            raise _later("11 (warm cache)")
        if not self.supports(query):
            raise ValueError(
                f"lane pool cannot serve func={query.func!r} "
                f"metric={query.metric!r} (supported funcs: "
                f"{sorted(self._family)}, metric {self._spec['metric']!r}, "
                f"absolute epsilon, no predicate)")
        if key is None:
            self.key, key = keylib.split(self.key)
        scale_row = self._scale_rows.get(query.func)
        if scale_row is None:
            scale_row = estimators.population_scale_row(
                query.func, self.data.scale)
            self._scale_rows[query.func] = scale_row
        qid = self._next_qid
        self._next_qid += 1
        self.submitted += 1
        self._queue.append(_Ticket(
            qid=qid, func=query.func, fid=self._family[query.func],
            epsilon=float(query.epsilon), delta=float(query.delta),
            key=keylib.as_key(key), scale_row=scale_row,
            submitted_s=time.perf_counter(), priority=int(priority),
            deadline_at=deadline_at))
        self.peak_queue_depth = max(self.peak_queue_depth, len(self._queue))
        return qid

    def submit_group(self, query: Query, key=None, **kwargs) -> int:
        raise _later("13 (grouped blocks)")

    # -- scheduling ---------------------------------------------------------
    def _place_tier(self) -> Optional[int]:
        """The free-laned tier with the smallest active watermark."""
        best, best_w = None, None
        for ti, t in enumerate(self._tiers):
            if t.busy == self.tier_lanes:
                continue
            w = t.width
            if best is None or w < best_w:
                best, best_w = ti, w
        return best

    def _refill(self) -> None:
        if not self._queue:
            return
        now = time.perf_counter()
        rounds: Dict[int, list] = {}
        while self._queue:
            ti = self._place_tier()
            if ti is None:
                break
            tk = min(self._queue, key=lambda t: t.order)
            self._queue.remove(tk)
            tier = self._tiers[ti]
            lane = next(i for i, t in enumerate(tier.occupant) if t is None)
            tk.spliced_s, tk.spliced_tick = now, self.ticks
            tk.spliced_width = tier.width
            tier.occupant[lane] = tk
            # The splice resets the watermark on the card; mirror it here.
            tier.filled_host[lane] = 0
            rounds.setdefault(ti, []).append((lane, tk))
        for ti, picks in rounds.items():
            tier = self._tiers[ti]
            _splice(tier.state, tier.params, [lane for lane, _ in picks],
                    np.stack([tk.key for _, tk in picks]),
                    np.stack([tk.scale_row for _, tk in picks]),
                    np.asarray([tk.epsilon for _, tk in picks]),
                    np.asarray([tk.delta for _, tk in picks]),
                    np.asarray([tk.fid for _, tk in picks]),
                    n_min=self._spec["n_min"])

    def _harvest(self) -> int:
        """Retire finished lanes; returns the number retired this sync."""
        max_iters = self._spec["max_iters"]
        now = time.perf_counter()
        n_retired = 0
        for ti, tier in enumerate(self._tiers):
            if tier.busy == 0:
                continue
            s = tier.state
            tl = self.tier_lanes
            host = torch.cat([s.done.to(torch.int64), s.failed.to(torch.int64),
                              s.k.to(torch.int64),
                              s.filled.to(torch.int64).reshape(-1)]).cpu()
            host = host.numpy()
            done, failed = host[:tl] != 0, host[tl:2 * tl] != 0
            k, filled = host[2 * tl:3 * tl], host[3 * tl:].reshape(tl, -1)
            tier.filled_host = filled.copy()
            finished = [lane for lane, t in enumerate(tier.occupant)
                        if t is not None
                        and (done[lane] or failed[lane]
                             or k[lane] >= max_iters)]
            if not finished:
                continue
            e, n_cur, iters = s.e.cpu().numpy(), s.n_cur.cpu().numpy(), \
                s.iters.cpu().numpy()
            theta, beta = s.theta.cpu().numpy(), s.beta.cpu().numpy()
            for lane in finished:
                t = tier.occupant[lane]
                rows = int(filled[lane].sum())
                self.results[t.qid] = PoolResponse(
                    qid=t.qid, func=t.func, theta=theta[lane].copy(),
                    error=float(e[lane]), success=bool(done[lane]),
                    failed=bool(failed[lane]), n=n_cur[lane].copy(),
                    iterations=int(iters[lane]), rows_sampled=rows,
                    wall_time_s=now - t.submitted_s,
                    queue_wait_s=t.spliced_s - t.submitted_s,
                    ticks_in_lane=self.ticks - t.spliced_tick,
                    lane=ti * self.tier_lanes + lane, tier=ti,
                    spliced_tier_width=t.spliced_width,
                    beta=beta[lane].copy())
                tier.occupant[lane] = None
                self.retired += 1
                self._retired_rows += rows
                n_retired += 1
        return n_retired

    def tick(self) -> int:
        """One scheduling round: refill, run ``ticks_per_sync`` ticks per
        busy tier (one dispatch each), harvest.  Returns busy lanes."""
        self._maybe_rotate()
        self._refill()
        ran = False
        for tier in self._tiers:
            busy = tier.busy
            if not busy:
                continue
            tier.state = fused_step(
                self._values, self._offsets, tier.state, tier.params,
                num_ticks=self.ticks_per_sync, **self._spec)
            self.dispatches += 1
            self.lane_ticks_busy += busy * self.ticks_per_sync
            self._active_frac_sum += busy / self.tier_lanes
            ran = True
        if not ran:
            return 0
        self.ticks += self.ticks_per_sync
        self._harvest()
        return self.busy_lanes

    def drain(self, max_ticks: int = 100_000) -> List[PoolResponse]:
        """Tick until the queue and every lane are empty; pop and return
        every retired result not yet collected, in qid order."""
        guard = 0
        while (self._queue or self.busy_lanes) and guard < max_ticks:
            self.tick()
            guard += self.ticks_per_sync
        return [self.results.pop(qid) for qid in sorted(self.results)]

    # -- epoch policy -------------------------------------------------------
    def set_sample_key(self, sample_key) -> None:
        """Rotate the pool-shared slot->row binding; only legal while idle
        (a resident lane's prefix is defined by the old binding)."""
        if self.busy_lanes or self._queue:
            raise RuntimeError("cannot rotate sample_key with queries in "
                               "flight; drain() first or use "
                               "request_sample_key()")
        self._apply_sample_key(sample_key)

    def request_sample_key(self, sample_key) -> bool:
        """Deferred rotation for a live pool: applied now if no lane is
        busy, else at the next idle point.  Returns True when applied now;
        a newer request supersedes an unapplied one."""
        self._pending_sample_key = keylib.as_key(sample_key)
        return self._maybe_rotate()

    def _maybe_rotate(self) -> bool:
        if self._pending_sample_key is None or self.busy_lanes:
            return False
        key, self._pending_sample_key = self._pending_sample_key, None
        self._apply_sample_key(key)
        return True

    def _apply_sample_key(self, sample_key) -> None:
        self._sample_key = keylib.as_key(sample_key)
        slot_idx = counter_slot_table(
            self._sample_key, self._offsets[:-1], np.diff(self._offsets),
            self._spec["n_cap"], device=self.device)
        for tier in self._tiers:
            tier.params = tier.params._replace(slot_idx=slot_idx)
        self.sample_epochs += 1

    # -- accounting ---------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        cap = max(self.ticks * self.lanes, 1)
        resident = sum(
            int(t.filled_host[i].sum())
            for t in self._tiers
            for i, tk in enumerate(t.occupant) if tk is not None)
        rows_gathered = self._retired_rows + resident
        return {
            "lanes": self.lanes,
            "tiers": self.tiers,
            "ticks_per_sync": self.ticks_per_sync,
            "ticks": self.ticks,
            "dispatches": self.dispatches,
            "submitted": self.submitted,
            "retired": self.retired,
            "queue_depth": self.queue_depth,
            "peak_queue_depth": self.peak_queue_depth,
            "lane_occupancy": self.lane_ticks_busy / cap,
            "active_lane_fraction": (
                self._active_frac_sum / max(self.dispatches, 1)),
            "rows_gathered": float(rows_gathered),
            "rows_per_tick": rows_gathered / max(self.ticks, 1),
            "sample_epochs": self.sample_epochs,
            "pending_rotation": self._pending_sample_key is not None,
        }
