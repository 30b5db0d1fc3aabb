"""AQP-as-a-service: the batch-synchronous wrapper of the session.

:class:`AQPService` keeps the original surface: ``answer(List[Query])``
submits the whole batch into an :class:`~.session.AQPSession` and drains
it, returning :class:`AQPResponse` rows in query order.  ``batch_fused``
maps onto the planner's route policy:

  * ``"auto"`` (default) -- the planner's heuristic: the pool whenever it
    is already busy or >= 2 fusable requests arrive together, the
    per-query loop for cold singletons;
  * ``"pool"`` / ``True`` / ``False`` -- force Route.POOL / Route.BATCHED /
    Route.LOOP for every fusable request.

Every other request runs on the HOST route (the engine), against the
session's resident sample store, so repeated batches reuse its prefixes.
Sample reuse, the reshuffle epoch policy and the accounting
(``rows_touched``, ``fused_dispatches``) live in the session.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..aqp.query import Query, Request
from ..core.sampling import GroupedData
from .lane_pool import LanePool
from .planner import FUSABLE, Planner, Route
from .session import AQPSession


@dataclasses.dataclass
class AQPResponse:
    qid: int
    theta: np.ndarray
    error: float
    success: bool
    n: np.ndarray
    wall_time_s: float


def _route_of(batch_fused) -> Optional[Route]:
    """Translate the legacy ``batch_fused`` knob into a forced Route
    (None = the planner's auto heuristic)."""
    if batch_fused == "auto":
        return None
    if batch_fused == "pool":
        return Route.POOL
    if batch_fused in (True, False):
        # Truthy equals (1, 0, np.True_) normalize to real bools here --
        # no more identity dispatch downstream.
        return Route.BATCHED if batch_fused else Route.LOOP
    raise ValueError(
        f"batch_fused must be True, False, 'auto' or 'pool'; "
        f"got {batch_fused!r}")


class AQPService:
    """Serve Listing-1 queries against one resident GroupedData."""

    FUSABLE = FUSABLE

    def __init__(self, data: GroupedData, *, B: int = 300, n_min: int = 1000,
                 n_max: int = 2000, max_iters: int = 24,
                 n_cap: int = 1 << 16, seed: int = 0,
                 reshuffle_every: int = 256,
                 use_kernel: "bool | str" = "auto",
                 batch_fused: "bool | str" = "auto",
                 pool_lanes: Optional[int] = None,
                 pool_ticks_per_sync: Optional[int] = None,
                 pool_tiers: "int | str" = "auto",
                 warm_cache: bool = False):
        mode = _route_of(batch_fused)
        self.batch_fused = (batch_fused if isinstance(batch_fused, str)
                            else bool(batch_fused))
        self.session = AQPSession(
            data, B=B, n_min=n_min, n_max=n_max, max_iters=max_iters,
            n_cap=n_cap, seed=seed, reshuffle_every=reshuffle_every,
            use_kernel=use_kernel, pool_tiers=pool_tiers,
            warm_cache=warm_cache,
            planner=Planner(mode=mode, pool_lanes=pool_lanes,
                            pool_ticks_per_sync=pool_ticks_per_sync))

    # -- delegated surface (the attributes callers and benchmarks read) ----
    @property
    def data(self) -> GroupedData:
        return self.session.data

    @property
    def store(self):
        return self.session.store

    @property
    def engine(self):
        return self.session.engine

    @property
    def use_kernel(self) -> bool:
        return self.session.use_kernel

    @property
    def rows_touched(self) -> int:
        return self.session.rows_touched

    @property
    def fused_dispatches(self) -> int:
        return self.session.fused_dispatches

    @fused_dispatches.setter
    def fused_dispatches(self, value: int) -> None:
        self.session.fused_dispatches = value

    @property
    def _sample_key(self):
        return self.session._sample_key

    @property
    def _lane_pool(self) -> Optional[LanePool]:
        return self.session._pool

    def refresh(self, data: Optional[GroupedData] = None) -> None:
        """Invalidate resident samples after a data update."""
        self.session.refresh(data)

    def answer(self, queries: List[Query]) -> List[AQPResponse]:
        """Answer a batch of queries: submit them all into the session,
        drain it, and return responses in query order.

        All fused queries of an epoch share the session's ``sample_key``:
        their slot->row bindings are identical, so every lane reads the
        SAME underlying rows (one hot working set, one slot table per
        program).  Identical rows mean correlated answers; that is the
        deliberate trade the reshuffle_every policy bounds.  Bootstrap
        keys stay per-query, so replicate noise is independent.
        """
        requests = [Request(query=q) for q in queries]
        tickets = [self.session.submit(r) for r in requests]
        del tickets     # drain() collects; rids key the mapping below
        # drain() also pops residue responses from a previous interrupted
        # answer(); their rows were already accounted at harvest, so they
        # are simply dropped here.
        by_rid = {r.rid: r for r in self.session.drain()}
        out = []
        for i, req in enumerate(requests):
            r = by_rid[req.rid]
            out.append(AQPResponse(
                qid=i, theta=r.theta, error=r.error, success=r.success,
                n=r.n, wall_time_s=r.wall_time_s))
        return out
