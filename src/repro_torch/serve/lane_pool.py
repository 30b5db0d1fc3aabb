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

A GROUP BY query is admitted as a resident lane BLOCK (:meth:`submit_group`):
one lane per group, ticked in the same scheduling round as the tiers with
one shared-scan dispatch (``fused_step(..., seg_cap=...)``), retired whole
when every group has finished.

Warm start: ``submit``/``submit_group`` take a cached prediction
(``warm_n0``/``warm_beta``) and splice the query as a WARM lane or block,
whose tick 0 jumps to the prediction and verifies it.

Overload scheduling (:mod:`.slo`), all off by default, with the pool above
as the exact special case:

* ``degrade`` -- a deadline-carrying ticket is planned at admission against
  the cost model: admitted, admitted at a relaxed epsilon (a degraded lane
  is a normal lane at the delivered bound), or SHED, answered at once from
  an ``n_min`` pilot with its measured error bar and never laned.  A
  deadline already blown at submit, or hopeless behind the queue, is shed
  in :meth:`submit`;
* ``wfq`` -- weighted fair queueing over ``Request.tenant``: the admission
  order is priority, then the tenant's virtual finish time, then deadline,
  then FIFO;
* ``migrate`` -- a straggler that alone drives its tier's ESTIMATE bucket
  is moved, mid-flight, into a tier already riding that bucket (or an
  empty one): a full row copy of its state and parameters, so its answer
  does not change.

Sharding (``data_shards = S > 1``): the table is cut into S row blocks of a
:class:`~repro_torch.core.sampling.ShardLayout` and every lane buffer into S
slot segments, ticked by the sharded step.  ``mesh=False`` keeps all S
segments on one device (the padded table, a sequential fold of the S
partial sums); a :class:`~repro_torch.core.mesh.DataMesh` makes this pool
one rank of an SPMD group: it holds its row block and its buffer segments,
runs the same host schedule as every other rank, and a tick crosses one
collective.  The mesh pool drains bit-equal to the ``mesh=False`` pool of
the same layout.  Under a mesh every clock reading a policy acts on (the
deadline stamps, the shed and degrade decisions, the cost model's round
times) is rank 0's, broadcast, so the ranks never disagree on a decision.
GROUP BY blocks and migration stay single-shard.

On a card, a single-shard pool replays each tick's phase before its host
read and its finish-and-test phase after the moment sums from CUDA graphs
(:class:`~repro_torch.core.graphs.TickGraphs`, one capture a shape and
phase, shared by its tiers and blocks); the answers are those of the eager
tick bit for bit.  A sharded card pool's step runs both phases eagerly and
counts them so in the same object.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..aqp.query import Query
from ..core import bootstrap, estimators, sanitize, trace
from ..core import keys as keylib
from ..core.fused import (LaneParams, LaneState, bucket_ladder, fused_step,
                          grouped_seg_cap, init_lane_state, lane_boot_seed,
                          make_group_lane_params, make_lane_params,
                          make_shard_spec, make_sharded_lane_params,
                          make_sharded_step, resolve_ext_cap,
                          resolve_seg_window)
from ..core.graphs import TickGraphs
from ..core.mesh import make_data_mesh
from ..core.sampling import (GroupedData, ShardLayout, counter_slot_table,
                             sharded_slot_tables, stratified_slot_tables)
from ..kernels import resolve_use_kernel
from .slo import PILOT_B_FLOOR, AdmissionController, FairQueue, predict_n0


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
    tier: int               # width tier the query rode in (-1: shed)
    spliced_tier_width: int  # tier's max active watermark at splice time
    beta: Optional[np.ndarray] = None   # (m+1,) final fitted coefficients
    warm: bool = False      # lane started from a cached prediction
    # The delivered contract: a degraded lane ran at ``delivered_epsilon >
    # epsilon``; a shed answer is an n_min pilot whose delivered epsilon is
    # its measured error.  Either way ``error <= delivered_epsilon``.
    epsilon: Optional[float] = None            # requested bound
    delivered_epsilon: Optional[float] = None  # bound actually satisfied
    delivered_B: Optional[int] = None          # replicates actually run
    degraded: bool = False   # epsilon relaxed at admission
    shed: bool = False       # answered by pilot, never laned
    migrations: int = 0      # cross-tier moves while resident
    tenant: str = ""         # fair-queueing traffic class


@dataclasses.dataclass
class GroupPoolResponse:
    """One retired GROUP BY query: one answer and one ``(epsilon, delta)``
    verdict per group.  ``success`` is the conjunction over groups,
    ``error`` the (G,) per-group quantiles."""
    qid: int
    func: str
    theta: np.ndarray          # (G,) scaled per-group estimates
    error: np.ndarray          # (G,) per-group error quantiles
    group_success: np.ndarray  # (G,) per-group verdicts
    success: bool              # every group met its bound
    failed: bool               # any group hit an Algorithm-2 failure
    n: np.ndarray              # (G,) final per-group sizes
    iterations: np.ndarray     # (G,) per-group iteration counts
    rows_sampled: int          # sum of per-group filled watermarks
    wall_time_s: float         # submit -> harvest
    queue_wait_s: float        # 0.0: blocks admit at submit
    ticks_in_block: int        # loop ticks while resident
    beta: Optional[np.ndarray] = None   # (G, 2) per-group coefficients
    warm: bool = False         # block started from a cached prediction
    group_by: bool = True


@dataclasses.dataclass
class _Block:
    """One resident grouped block: its own carry/params, ticked whole."""
    qid: int
    func: str
    state: LaneState           # q = G lanes of m = 1
    params: LaneParams
    submitted_s: float
    admitted_tick: int
    warm: bool = False


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
    warm_n0: Optional[np.ndarray] = None    # (m,) cached n* prediction
    warm_beta: Optional[np.ndarray] = None  # (m+1,) cached coefficients
    tenant: str = ""                        # fair-queueing traffic class
    vft: float = 0.0                        # WFQ virtual finish time
    delivered_epsilon: Optional[float] = None  # set when degraded
    degraded: bool = False
    migrations: int = 0                     # cross-tier moves while resident
    spliced_s: float = 0.0
    spliced_tick: int = 0
    spliced_width: int = 0

    @property
    def order(self):
        """Admission order: priority class first, then the weighted-fair
        virtual finish time (0.0 for every ticket without fair queueing),
        then earliest deadline, then FIFO.  Order changes WHEN a query is
        spliced, never its trajectory."""
        ddl = self.deadline_at if self.deadline_at is not None else np.inf
        return (-self.priority, self.vft, ddl, self.qid)

    @property
    def eps_run(self) -> float:
        """The bound the lane runs at (degraded or requested)."""
        return (self.delivered_epsilon if self.delivered_epsilon is not None
                else self.epsilon)


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
            deltas: np.ndarray, fids: np.ndarray, warm: np.ndarray,
            warm_n0: np.ndarray, warm_beta: np.ndarray, *,
            n_min: int) -> None:
    """Reset ``lanes`` to tick 0 IN PLACE, swapping in their new queries --
    row for row what ``init_lane_state``/``make_lane_params`` build, so a
    refilled lane is indistinguishable from a lane of a fresh pool.

    The rows are host values uploaded one by one, each upload waiting for
    the device: a named transfer (:func:`sanitize.harvest`)."""
    with sanitize.harvest("lane_pool.refill.upload"):
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
        put(params.warm, warm.astype(np.bool_))
        put(params.warm_n0, warm_n0.astype(np.int32))
        put(params.warm_beta, warm_beta.astype(np.float32))


# The per-lane rows a cross-tier migration carries: every LaneState leaf
# and the per-lane LaneParams rows _splice swaps.  ``slot_idx`` is shared by
# every tier (one sample key), so the moved lane rebinds to the same table.
_STATE_LEAVES = LaneState._fields
_PARAM_LANE_LEAVES = ("scale", "epsilons", "deltas", "est_fids", "boot_base",
                      "warm", "warm_n0", "warm_beta")


def _migrate(src_st: LaneState, src_pr: LaneParams, dst_st: LaneState,
             dst_pr: LaneParams, src_lane: int, dst_lane: int) -> None:
    """Copy lane ``src_lane`` of one tier into ``dst_lane`` of another IN
    PLACE, mid-flight (indexed copies on the device, no host read), and park
    the source lane as done."""
    for f in _STATE_LEAVES:
        getattr(dst_st, f)[dst_lane] = getattr(src_st, f)[src_lane]
    for f in _PARAM_LANE_LEAVES:
        getattr(dst_pr, f)[dst_lane] = getattr(src_pr, f)[src_lane]
    src_st.done[src_lane] = True


class LanePool:
    """A fixed pool of query lanes with width-aware admission and
    retire-and-refill.  ``ticks_per_sync`` trades host round-trips against
    refill granularity; ``tiers="auto"`` splits an even pool into two width
    tiers.  ``degrade``/``wfq``/``tenant_weights``/``migrate`` arm the
    overload policies.  ``data_shards > 1`` shards the pool: ``mesh=False``
    on one device, a :class:`~repro_torch.core.mesh.DataMesh` as one rank of
    it, ``None`` the default process group's mesh.  ``graphs`` shares a
    graph cache whose captures and counts outlive this pool (a session's);
    by default a card pool makes its own."""

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
                 migrate: bool = False, max_degrade: float = 8.0,
                 graphs: Optional[TickGraphs] = None):
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
        self.data_shards = int(data_shards)
        self._layout: Optional[ShardLayout] = None
        self._mesh = None
        l = int(l if l is not None else min(m + 2, 12))
        if self.data_shards > 1:
            self._layout = ShardLayout.build(self._offsets, n_cap=n_cap,
                                             num_shards=self.data_shards)
            if mesh is not False:
                self._mesh = (mesh if mesh is not None
                              else make_data_mesh(self.data_shards))
                if self._mesh.size != self.data_shards:
                    raise ValueError(
                        f"mesh has {self._mesh.size} ranks; pool wants "
                        f"data_shards={self.data_shards}")
                # A rank places only its row block, on its own device.
                self.device = self._mesh.device
                self._values = self._layout.block_values(
                    data.values, self._mesh.rank).to(self.device)
            else:
                self._values = self._layout.pad_values(data.values)
            self._shard_spec = make_shard_spec(self._layout,
                                               device=self.device)
            self._spec = dict(
                est_name=None, B=B, n_min=n_min, n_max=n_max, l=l,
                tau=1e-3, max_iters=max_iters, n_cap=n_cap, metric=metric,
                growth_cap=growth_cap,
                seg_window=resolve_seg_window(n_cap, n_max, self.data_shards,
                                              ext_cap),
                use_kernel=resolve_use_kernel(use_kernel, self.device),
                data_shards=self.data_shards)
        else:
            self._values = data.values
            self._spec = dict(
                est_name=None, B=B, n_min=n_min, n_max=n_max, l=l, tau=1e-3,
                max_iters=max_iters, n_cap=n_cap, metric=metric,
                growth_cap=growth_cap,
                ext_cap=resolve_ext_cap(n_cap, n_max, ext_cap), adaptive=True,
                use_kernel=resolve_use_kernel(use_kernel, self.device),
                gate_gather=gate_gather)
        self.ticks_per_sync = int(ticks_per_sync)
        # On a card the tick's pre-read and finish-and-test phases replay
        # from CUDA graphs; the sharded step runs them eagerly and counts
        # them in ``eager``.  The CPU runs them eagerly, uncounted.
        self.graphs: Optional[TickGraphs] = None
        if self.device.type == "cuda":
            self.graphs = graphs if graphs is not None else TickGraphs()
        self.key = keylib.prng_key(seed)
        if sample_key is None:
            sample_key = keylib.prng_key(seed ^ 0x5A17)
        self._sample_key = keylib.as_key(sample_key)
        keys0 = keylib.split(keylib.prng_key(seed), self.lanes)
        tl = self.tier_lanes
        self._tiers: List[_Tier] = []
        # A mesh rank's buffers hold its own segment of the slot axis.
        buf_cap = n_cap if self._mesh is None else self._layout.seg_cap
        for ti in range(self.tiers):
            tkeys = keys0[ti * tl:(ti + 1) * tl]
            if self._layout is not None:
                params = make_sharded_lane_params(
                    self._layout, np.ones((tl, m), np.float32), tkeys,
                    np.ones((tl,), np.float32),
                    np.full((tl,), 0.05, np.float32), self._sample_key,
                    np.zeros((tl,), np.int32),
                    local_rows=self._mesh is not None, device=self.device)
                params = params._replace(
                    slot_idx=self._own_tables(params.slot_idx))
            else:
                params = make_lane_params(
                    self._offsets, np.ones((tl, m), np.float32), tkeys,
                    np.ones((tl,), np.float32),
                    np.full((tl,), 0.05, np.float32), self._sample_key,
                    np.zeros((tl,), np.int32), n_cap=n_cap,
                    device=self.device)
            state = init_lane_state(
                tkeys, m, n_cap=buf_cap, c_dim=data.values.shape[1], p_dim=1,
                n_min=n_min, max_iters=max_iters, device=self.device,
                dtype=data.values.dtype)
            # Empty lanes are parked as ``done``: the step freezes them
            # (gated bootstrap and gated gather) until a splice.
            state.done.fill_(True)
            self._tiers.append(_Tier(
                state=state, params=params, occupant=[None] * tl,
                filled_host=np.zeros((tl, m), np.int64)))
        self._queue: Deque[_Ticket] = deque()
        # Resident grouped blocks.  Admission is at submit (no ticket
        # queue); every block of the pool has q = num_groups lanes of m = 1
        # and steps on the dummy offsets [0, N]: its slot tables already
        # hold global rows.
        self._blocks: Dict[int, _Block] = {}
        self._gseg_cap = (grouped_seg_cap(self._offsets, n_cap)
                          if self.data_shards == 1 else 0)
        self._goffsets = [0, int(self._offsets[-1])]
        self._gtables: Optional[torch.Tensor] = None  # per sample epoch
        self._pending_sample_key: Optional[np.ndarray] = None
        self.sample_epochs = 0
        self._scale_rows: Dict[str, np.ndarray] = {}
        self.warm_spliced = 0     # warm lanes and blocks admitted
        # Overload policies, all off by default.  Migration needs two tiers.
        self._slo = AdmissionController(
            bucket_ladder(n_cap, n_max), num_groups=m, n_min=n_min,
            max_degrade=max_degrade) if degrade else None
        self._wfq = FairQueue(tenant_weights) if wfq else None
        self.migrate_enabled = (bool(migrate) and self.tiers >= 2
                                and self.data_shards == 1)
        # Under a mesh a policy that reads the clock takes rank 0's reading.
        self._sync_clock = self._mesh is not None and degrade
        self.shed = 0             # requests answered by pilot, never laned
        self.degraded = 0         # requests admitted at a relaxed epsilon
        self.migrations = 0       # cross-tier lane moves
        self.steady_recompiles = 0  # libraries built/loaded after round 1
        self._steady_cache0: Optional[int] = None
        self._group_sizes_host = np.diff(self._offsets).astype(np.int64)
        self._pilot_tab: Optional[torch.Tensor] = None   # per sample epoch
        # Hand-off buffer: harvest fills it, drain() pops it.
        self.results: Dict[int, PoolResponse] = {}
        self._next_qid = 0
        self.ticks = 0            # scheduling rounds executed
        self.dispatches = 0       # step launches (tier syncs)
        self.lane_ticks_busy = 0  # occupied-lane ticks (occupancy integral)
        self.submitted = 0
        self.retired = 0
        self.grouped_submitted = 0   # blocks admitted
        self.grouped_retired = 0     # blocks harvested
        self.block_ticks = 0         # block-resident loop ticks
        self.peak_queue_depth = 0
        self._retired_rows = 0
        # Per-shard slot residency of retired queries (a single-shard pool
        # reports one shard).
        self._shard_rows_retired = np.zeros((self.data_shards,), np.int64)

    def _own_tables(self, tables: torch.Tensor) -> torch.Tensor:
        """This pool's slice of stacked ``(S, m, seg_cap)`` slot tables: a
        mesh rank keeps its own ``(1, m, seg_cap)`` local table."""
        if self._mesh is None:
            return tables
        r = self._mesh.rank
        return tables[r:r + 1].contiguous()

    def _clock(self) -> float:
        """``time.perf_counter()``, rank 0's under a mesh while a policy
        that acts on it (degrade) is armed."""
        t = time.perf_counter()
        return self._mesh.broadcast_float(t) if self._sync_clock else t

    # -- admission ----------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def busy_lanes(self) -> int:
        return sum(t.busy for t in self._tiers)

    @property
    def busy_blocks(self) -> int:
        return len(self._blocks)

    def supports(self, query: Query) -> bool:
        """Whether this pool can serve ``query`` (moment family, this
        metric, absolute bound, no predicate, no GROUP BY)."""
        return (query.func in self._family
                and query.metric == self._spec["metric"]
                and query.epsilon is not None
                and query.predicate is None and not query.group_by)

    def submit(self, query: Query, key=None, *, priority: int = 0,
               deadline_at: Optional[float] = None, warm_n0=None,
               warm_beta=None, tenant: str = "") -> int:
        """Enqueue one query; returns its qid (results keyed on it).

        ``priority``/``deadline_at`` (absolute ``time.perf_counter``) shape
        admission order; with ``wfq`` the tenant's virtual finish time sits
        between them.  With ``degrade`` a deadline blown at submit, or
        hopeless behind the queue, is shed HERE: its pilot answer is in
        :attr:`results` when this returns.  ``warm_n0 (m,)``/``warm_beta
        (m+1,)`` (both or neither) splice the query as a WARM lane.
        """
        if (warm_n0 is None) != (warm_beta is None):
            raise ValueError("warm_n0 and warm_beta come together")
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
        m = self.data.num_groups
        if warm_n0 is not None:
            # The step clips n to the group sizes and n_cap anyway; this
            # keeps an oversized prediction inside int32.
            warm_n0 = np.clip(np.asarray(warm_n0, np.int64).reshape((m,)),
                              1, self._spec["n_cap"]).astype(np.int32)
            warm_beta = np.asarray(warm_beta, np.float32).reshape((m + 1,))
        vft = 0.0
        if self._wfq is not None:
            # The fair-queueing cost is the predicted watermark, the rows a
            # lane holds; n_min while the cost model is unprimed.
            wm = None
            if self._slo is not None:
                wm = self._slo.cost.predict_watermark(
                    query.func, float(query.epsilon), warm_n0=warm_n0)
            if wm is None:
                wm = (int(np.max(warm_n0)) if warm_n0 is not None
                      else self._spec["n_min"])
            vft = self._wfq.stamp(tenant, float(wm))
        tk = _Ticket(
            qid=qid, func=query.func, fid=self._family[query.func],
            epsilon=float(query.epsilon), delta=float(query.delta),
            key=keylib.as_key(key), scale_row=scale_row,
            submitted_s=self._clock(), priority=int(priority),
            deadline_at=deadline_at, warm_n0=warm_n0, warm_beta=warm_beta,
            tenant=str(tenant), vft=vft)
        if self._slo is not None and deadline_at is not None and (
                deadline_at <= tk.submitted_s or self._slo.hopeless(
                    queue_ahead=len(self._queue), busy=self.busy_lanes,
                    lanes=self.lanes, deadline_at=deadline_at,
                    now=tk.submitted_s)):
            self._shed(tk, tk.submitted_s)
            return qid
        self._queue.append(tk)
        self.peak_queue_depth = max(self.peak_queue_depth, len(self._queue))
        return qid

    def supports_grouped(self, query: Query) -> bool:
        """Whether this pool can serve ``query`` as a grouped lane block
        (the clause constraints of :meth:`supports`, GROUP BY or not, on a
        single-shard pool: the packed shared scan is not sharded)."""
        return (self.data_shards == 1 and query.func in self._family
                and query.metric == self._spec["metric"]
                and query.epsilon is not None and query.predicate is None)

    def _grouped_tables(self) -> torch.Tensor:
        """The stratified slot tables under the current sample key, built
        once per epoch and shared by every block admitted in it (rotation,
        which fires only with no block resident, drops them)."""
        if self._gtables is None:
            self._gtables = stratified_slot_tables(
                self._sample_key, self._offsets, self._spec["n_cap"],
                device=self.device)
        return self._gtables

    def submit_group(self, query: Query, key=None, *, warm_n0=None,
                     warm_beta=None) -> int:
        """Admit one GROUP BY query as a resident lane BLOCK; returns its
        qid.  Lane g's bootstrap key is ``fold_in(key, g)`` and its slot
        table stratum g of the pool's sample key.  The block is built here
        and ticks from the next round on; its :class:`GroupPoolResponse`
        lands in :attr:`results` once every group has converged, failed or
        run out of iterations.  ``warm_n0 (G,)``/``warm_beta (G, 2)`` (both
        or neither) start every lane of the block warm."""
        if (warm_n0 is None) != (warm_beta is None):
            raise ValueError("warm_n0 and warm_beta come together")
        if not self.supports_grouped(query):
            raise ValueError(
                f"lane pool cannot serve grouped func={query.func!r} "
                f"metric={query.metric!r} (needs a moment-family func, "
                f"metric {self._spec['metric']!r}, absolute epsilon, no "
                f"predicate, data_shards == 1)")
        if key is None:
            self.key, key = keylib.split(self.key)
        key = keylib.as_key(key)
        G = self.data.num_groups
        scale_row = self._scale_rows.get(query.func)
        if scale_row is None:
            scale_row = estimators.population_scale_row(
                query.func, self.data.scale)
            self._scale_rows[query.func] = scale_row
        keys = np.stack([keylib.fold_in(key, g) for g in range(G)])
        n_cap = self._spec["n_cap"]
        if warm_n0 is not None:
            warm_n0 = np.clip(np.asarray(warm_n0, np.int64).reshape((G,)),
                              1, n_cap).astype(np.int32).reshape(G, 1)
            warm_beta = np.asarray(warm_beta, np.float32).reshape((G, 2))
            self.warm_spliced += 1
        params = make_group_lane_params(
            self._offsets, scale_row, keys,
            np.full((G,), query.epsilon, np.float32),
            np.full((G,), query.delta, np.float32), self._sample_key,
            np.full((G,), self._family[query.func], np.int32), n_cap=n_cap,
            warm_n0=warm_n0, warm_beta=warm_beta,
            slot_idx=self._grouped_tables(), device=self.device)
        state = init_lane_state(
            keys, 1, n_cap=n_cap, c_dim=self.data.values.shape[1], p_dim=1,
            n_min=self._spec["n_min"], max_iters=self._spec["max_iters"],
            device=self.device, dtype=self.data.values.dtype)
        qid = self._next_qid
        self._next_qid += 1
        self.submitted += 1
        self.grouped_submitted += 1
        self._blocks[qid] = _Block(
            qid=qid, func=query.func, state=state, params=params,
            submitted_s=time.perf_counter(), admitted_tick=self.ticks,
            warm=warm_n0 is not None)
        return qid

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
        now = self._clock()
        if self._slo is not None:
            # A queued ticket whose deadline passed while it waited is
            # answered by pilot now instead of taking a lane.
            for tk in [t for t in self._queue
                       if t.deadline_at is not None and t.deadline_at <= now]:
                self._queue.remove(tk)
                self._shed(tk, now)
        rounds: Dict[int, list] = {}
        while self._queue:
            ti = self._place_tier()
            if ti is None:
                break
            tk = min(self._queue, key=lambda t: t.order)
            self._queue.remove(tk)
            if self._slo is not None and tk.deadline_at is not None:
                # Plan against the cost model: admit, relax epsilon along
                # Eq. 13 to the largest rung that fits, or shed.
                plan = self._slo.plan(
                    func=tk.func, epsilon=tk.epsilon,
                    deadline_at=tk.deadline_at, now=now,
                    warm_n0=tk.warm_n0, warm_beta=tk.warm_beta)
                if plan.action == "shed":
                    self._shed(tk, now)
                    continue
                if plan.action == "degrade":
                    tk.delivered_epsilon = plan.epsilon
                    tk.degraded = True
                    self.degraded += 1
                    if tk.warm_n0 is not None:
                        # Re-aim the warm jump at the relaxed bound.
                        tk.warm_n0 = np.clip(
                            predict_n0(tk.warm_beta, plan.epsilon,
                                       n_min=self._spec["n_min"]),
                            1, self._spec["n_cap"]).astype(np.int32)
            tier = self._tiers[ti]
            lane = next(i for i, t in enumerate(tier.occupant) if t is None)
            tk.spliced_s, tk.spliced_tick = now, self.ticks
            tk.spliced_width = tier.width
            tier.occupant[lane] = tk
            # The splice resets the watermark on the card; mirror it here.
            tier.filled_host[lane] = 0
            if self._wfq is not None:
                self._wfq.on_admit(tk.vft)
            rounds.setdefault(ti, []).append((lane, tk))
        m = self.data.num_groups
        for ti, picks in rounds.items():
            tier = self._tiers[ti]
            tks = [tk for _, tk in picks]
            warm = np.asarray([tk.warm_n0 is not None for tk in tks])
            self.warm_spliced += int(warm.sum())
            _splice(tier.state, tier.params, [lane for lane, _ in picks],
                    np.stack([tk.key for tk in tks]),
                    np.stack([tk.scale_row for tk in tks]),
                    np.asarray([tk.eps_run for tk in tks]),
                    np.asarray([tk.delta for tk in tks]),
                    np.asarray([tk.fid for tk in tks]), warm,
                    np.stack([np.zeros((m,), np.int32) if tk.warm_n0 is None
                              else tk.warm_n0 for tk in tks]),
                    np.stack([np.zeros((m + 1,), np.float32)
                              if tk.warm_beta is None else tk.warm_beta
                              for tk in tks]),
                    n_min=self._spec["n_min"])

    # -- load shedding ------------------------------------------------------
    def _pilot_table(self) -> torch.Tensor:
        """The shed path's ``(m, n_pilot)`` slot tables under the current
        sample key, built once per epoch."""
        if self._pilot_tab is None:
            self._pilot_tab = counter_slot_table(
                self._sample_key, self._offsets[:-1],
                self._group_sizes_host, self._pilot_n(),
                device=self.data.device)
        return self._pilot_tab

    def _pilot_n(self) -> int:
        return int(min(self._spec["n_min"], self._spec["n_cap"]))

    def _pilot_estimate(self, tk: _Ticket, B: int):
        """One ``n_min``-wide stratified pilot ESTIMATE through the generic
        bootstrap, gathered from the unsharded table on its device (every
        layout sheds alike): ``(e, theta (m, 1))`` as host values, one host
        read."""
        dev = self.data.device
        with sanitize.harvest("lane_pool.shed.upload"):  # pilot uploads
            tab = self._pilot_table()
            n_pilot = tab.shape[1]
            sizes = torch.as_tensor(
                np.minimum(self._group_sizes_host, n_pilot), device=dev)
            scale = torch.as_tensor(tk.scale_row, dtype=torch.float32,
                                    device=dev)
        sample = self.data.values[tab.to(torch.int64)]         # (m, n, c)
        mask = (torch.arange(n_pilot, device=dev)[None, :]
                < sizes[:, None]).to(torch.float32)
        e, theta = bootstrap.estimate_error(
            estimators.get(tk.func), sample, mask, scale,
            tk.key, tk.delta, B=B, metric=self._spec["metric"])
        with sanitize.harvest("lane_pool.shed.read"):
            host = torch.cat([e.reshape(1), theta.reshape(-1)]).cpu().numpy()
        return float(host[0]), host[1:].reshape(theta.shape)

    def _shed(self, tk: _Ticket, now: float) -> None:
        """Answer ``tk`` at once from an n_min pilot: the response carries
        the MEASURED pilot error as its delivered epsilon and the pilot's
        reduced replicate count as its delivered B.  It never takes a
        lane."""
        pilot_B = max(PILOT_B_FLOOR, int(self._spec["B"]) // 4)
        err, theta = self._pilot_estimate(tk, pilot_B)
        n = np.minimum(self._group_sizes_host, self._pilot_n())
        rows = int(n.sum())
        self.results[tk.qid] = PoolResponse(
            qid=tk.qid, func=tk.func, theta=theta, error=err,
            success=bool(err <= tk.epsilon), failed=False, n=n,
            iterations=0, rows_sampled=rows,
            wall_time_s=time.perf_counter() - tk.submitted_s,
            queue_wait_s=now - tk.submitted_s, ticks_in_lane=0, lane=-1,
            tier=-1, spliced_tier_width=0, epsilon=tk.epsilon,
            delivered_epsilon=max(tk.epsilon, err), delivered_B=pilot_B,
            shed=True, tenant=tk.tenant)
        self.shed += 1
        self.retired += 1
        self._retired_rows += rows
        self._shard_rows_retired[0] += rows

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
            with sanitize.harvest("lane_pool.harvest.read"):
                host = torch.cat([
                    s.done.to(torch.int64), s.failed.to(torch.int64),
                    s.k.to(torch.int64),
                    s.filled.to(torch.int64).reshape(-1)]).cpu().numpy()
            done, failed = host[:tl] != 0, host[tl:2 * tl] != 0
            k, filled = host[2 * tl:3 * tl], host[3 * tl:].reshape(tl, -1)
            tier.filled_host = filled.copy()
            finished = [lane for lane, t in enumerate(tier.occupant)
                        if t is not None
                        and (done[lane] or failed[lane]
                             or k[lane] >= max_iters)]
            if not finished:
                continue
            with sanitize.harvest("lane_pool.harvest.read"):
                e, n_cur, iters = (s.e.cpu().numpy(), s.n_cur.cpu().numpy(),
                                   s.iters.cpu().numpy())
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
                    beta=beta[lane].copy(), warm=t.warm_n0 is not None,
                    epsilon=t.epsilon, delivered_epsilon=t.eps_run,
                    delivered_B=int(self._spec["B"]), degraded=t.degraded,
                    migrations=t.migrations, tenant=t.tenant)
                if self._slo is not None:
                    # Teach the cost model: the bound the lane ran at, how
                    # wide it grew, how long it stayed resident.
                    self._slo.cost.observe_retirement(
                        t.func, t.eps_run, int(filled[lane].max()),
                        self.ticks - t.spliced_tick)
                tier.occupant[lane] = None
                self.retired += 1
                self._retired_rows += rows
                if self._layout is not None:
                    self._shard_rows_retired += self._layout.shard_rows(
                        filled[lane])
                else:
                    self._shard_rows_retired[0] += rows
                n_retired += 1
        return n_retired

    def _harvest_blocks(self) -> int:
        """Retire the blocks whose EVERY lane has finished; per-group
        answers leave together as one :class:`GroupPoolResponse`.  One
        host read per block (all fields as float64, exact for int32 and
        float32)."""
        max_iters = self._spec["max_iters"]
        now = time.perf_counter()
        finished = []
        for qid, blk in self._blocks.items():
            s = blk.state
            G = s.k.shape[0]
            f64 = torch.float64
            with sanitize.harvest("lane_pool.harvest_blocks.read"):
                host = torch.cat([
                    s.done.to(f64), s.failed.to(f64), s.k.to(f64),
                    s.iters.to(f64), s.n_cur[:, 0].to(f64),
                    s.filled[:, 0].to(f64), s.e.to(f64),
                    s.theta[:, 0, 0].to(f64),
                    s.beta.reshape(-1).to(f64)]).cpu().numpy()
            done, failed, k, iters, n, filled, e, theta = \
                host[:8 * G].reshape(8, G)
            done, failed = done != 0, failed != 0
            if not np.all(done | failed | (k >= max_iters)):
                continue
            rows = int(filled.sum())
            self.results[qid] = GroupPoolResponse(
                qid=qid, func=blk.func, theta=theta.astype(np.float32),
                error=e.astype(np.float32), group_success=done,
                success=bool(done.all()), failed=bool(failed.any()),
                n=n.astype(np.int32), iterations=iters.astype(np.int32),
                rows_sampled=rows, wall_time_s=now - blk.submitted_s,
                queue_wait_s=0.0,
                ticks_in_block=self.ticks - blk.admitted_tick,
                beta=host[8 * G:].reshape(G, -1).astype(np.float32),
                warm=blk.warm)
            self.retired += 1
            self.grouped_retired += 1
            self._retired_rows += rows
            self._shard_rows_retired[0] += rows
            finished.append(qid)
        for qid in finished:
            del self._blocks[qid]
        return len(finished)

    def _maybe_migrate(self) -> None:
        """Cross-tier migration: when ONE straggler's watermark drives its
        tier's ESTIMATE bucket above what its tier-mates need, move it into
        a tier already riding that bucket (or an empty one).  A full row
        copy (:func:`_migrate`), so its trajectory is the one it would have
        had in place; at most one move a round."""
        if not self.migrate_enabled:
            return
        for si, src in enumerate(self._tiers):
            occ = [(int(src.filled_host[i].max()), i)
                   for i, tk in enumerate(src.occupant) if tk is not None]
            if len(occ) < 2:
                continue
            occ.sort(reverse=True)
            (w1, lane1), (w2, _) = occ[0], occ[1]
            if self.bucket_of(w1) <= self.bucket_of(w2):
                continue   # the straggler does not drive the bucket alone
            for di, dst in enumerate(self._tiers):
                if di == si or dst.busy == self.tier_lanes:
                    continue
                if dst.busy and self.bucket_of(dst.width) \
                        < self.bucket_of(w1):
                    continue   # would widen the destination's bucket
                dst_lane = next(i for i, t in enumerate(dst.occupant)
                                if t is None)
                _migrate(src.state, src.params, dst.state, dst.params,
                         lane1, dst_lane)
                tk = src.occupant[lane1]
                src.occupant[lane1] = None
                dst.occupant[dst_lane] = tk
                dst.filled_host[dst_lane] = src.filled_host[lane1]
                src.filled_host[lane1] = 0
                tk.migrations += 1
                self.migrations += 1
                return

    def tick(self) -> int:
        """One scheduling round: refill, run ``ticks_per_sync`` ticks per
        busy tier and per resident block (one dispatch each), harvest, feed
        the cost model, maybe migrate a straggler.  Returns busy lanes +
        blocks.

        The round runs under :func:`sanitize.guarded` (inert unless
        MISS_SANITIZE is set): every device sync in the pump path must be a
        named :func:`sanitize.harvest` read.  Afterwards the recompile
        sentinel attributes any CUDA library built or loaded after the
        first round to ``steady_recompiles``."""
        with trace.span("lane_pool.tick"), sanitize.guarded():
            out = self._tick_inner()
        size = sanitize.program_events()
        if self._steady_cache0 is None:
            self._steady_cache0 = size
        elif size > self._steady_cache0:
            self.steady_recompiles += size - self._steady_cache0
            self._steady_cache0 = size
        return out

    def _tick_inner(self) -> int:
        t0 = self._clock()
        self._maybe_rotate()
        with trace.span("lane_pool.refill"):
            self._refill()
        ran = False
        round_rung = 0
        for tier in self._tiers:
            busy = tier.busy
            if not busy:
                continue
            round_rung = max(round_rung, tier.width)
            with trace.span("lane_pool.tier_step"):
                if self._mesh is not None:
                    step = make_sharded_step(
                        self._mesh, num_ticks=self.ticks_per_sync,
                        graphs=self.graphs, **self._spec)
                    tier.state = step(self._values, tier.state, tier.params,
                                      self._shard_spec)
                else:
                    # One device; a sharded pool's spec carries its exact
                    # per-segment window and runs the sequential fold.
                    tier.state = fused_step(
                        self._values, self._offsets, tier.state, tier.params,
                        self._shard_spec if self._layout is not None
                        else None, num_ticks=self.ticks_per_sync,
                        graphs=self.graphs, **self._spec)
            self.dispatches += 1
            self.lane_ticks_busy += busy * self.ticks_per_sync
            ran = True
        for blk in self._blocks.values():
            with trace.span("lane_pool.block_step"):
                blk.state = fused_step(
                    self._values, self._goffsets, blk.state, blk.params,
                    num_ticks=self.ticks_per_sync, seg_cap=self._gseg_cap,
                    graphs=self.graphs, **self._spec)
            self.dispatches += 1
            self.block_ticks += self.ticks_per_sync
            ran = True
        if not ran:
            return 0
        self.ticks += self.ticks_per_sync
        with trace.span("lane_pool.harvest"):
            self._harvest()
        with trace.span("lane_pool.harvest_blocks"):
            self._harvest_blocks()
        if self._slo is not None:
            # The harvest's host read closed the round: the wall time covers
            # dispatch and sync.
            self._slo.cost.observe_round(
                self._clock() - t0, self.ticks_per_sync, round_rung)
        self._maybe_migrate()
        return self.busy_lanes + self.busy_blocks

    def drain(self, max_ticks: int = 100_000) -> List[PoolResponse]:
        """Tick until the queue and every lane are empty; pop and return
        every retired result not yet collected, in qid order."""
        guard = 0
        while (self._queue or self.busy_lanes or self._blocks) \
                and guard < max_ticks:
            self.tick()
            guard += self.ticks_per_sync
        return [self.results.pop(qid) for qid in sorted(self.results)]

    # -- epoch policy -------------------------------------------------------
    def set_sample_key(self, sample_key) -> None:
        """Rotate the pool-shared slot->row binding; only legal while idle
        (a resident lane's prefix is defined by the old binding)."""
        if self.busy_lanes or self._queue or self._blocks:
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
        if self._pending_sample_key is None or self.busy_lanes \
                or self._blocks:
            return False
        key, self._pending_sample_key = self._pending_sample_key, None
        self._apply_sample_key(key)
        return True

    def _apply_sample_key(self, sample_key) -> None:
        self._sample_key = keylib.as_key(sample_key)
        if self._layout is not None:
            slot_idx = self._own_tables(sharded_slot_tables(
                self._sample_key, self._layout,
                local_rows=self._mesh is not None, device=self.device))
        else:
            slot_idx = counter_slot_table(
                self._sample_key, self._offsets[:-1], np.diff(self._offsets),
                self._spec["n_cap"], device=self.device)
        for tier in self._tiers:
            tier.params = tier.params._replace(slot_idx=slot_idx)
        self._gtables = None
        self._pilot_tab = None
        self.sample_epochs += 1

    # -- accounting ---------------------------------------------------------
    def bucket_of(self, watermark: int) -> int:
        """The ESTIMATE bucket width a lane with ``watermark`` filled rows
        rides at -- what placement and migration minimize.  A sharded
        pool's buckets cover SEGMENT fills: the watermark is first scaled by
        the layout's largest per-shard share (a placement cost model only)."""
        n_cap, n_max = self._spec["n_cap"], self._spec["n_max"]
        if self._layout is not None:
            seg_cap = self._layout.seg_cap
            widths = bucket_ladder(seg_cap, min(n_max, seg_cap))
            watermark = int(np.ceil(
                watermark * self._layout.max_shard_frac()))
        else:
            widths = bucket_ladder(n_cap, n_max)
        return next((w for w in widths if watermark <= w), widths[-1])

    def shard_dispatch_rows(self) -> np.ndarray:
        """(S,) per-shard slot residency: retired queries' shares plus the
        resident lanes' watermarks pushed through the layout's ownership
        tables -- how the gather and bootstrap work split over the shards."""
        out = self._shard_rows_retired.copy()
        for t in self._tiers:
            for i, tk in enumerate(t.occupant):
                if tk is None:
                    continue
                if self._layout is not None:
                    out += self._layout.shard_rows(t.filled_host[i])
                else:
                    out[0] += int(t.filled_host[i].sum())
        return out

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
            "data_shards": self.data_shards,
            "shard_rows": [int(x) for x in self.shard_dispatch_rows()],
            "ticks_per_sync": self.ticks_per_sync,
            "ticks": self.ticks,
            "dispatches": self.dispatches,
            "submitted": self.submitted,
            "retired": self.retired,
            "grouped_submitted": self.grouped_submitted,
            "grouped_retired": self.grouped_retired,
            "busy_blocks": self.busy_blocks,
            "block_ticks": self.block_ticks,
            "queue_depth": self.queue_depth,
            "peak_queue_depth": self.peak_queue_depth,
            "lane_occupancy": self.lane_ticks_busy / cap,
            "rows_gathered": float(rows_gathered),
            "sample_epochs": self.sample_epochs,
            "pending_rotation": self._pending_sample_key is not None,
            "warm_spliced": self.warm_spliced,
            "shed": self.shed,
            "degraded": self.degraded,
            "migrations": self.migrations,
            "steady_recompiles": self.steady_recompiles,
        }
