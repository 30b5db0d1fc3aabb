"""The ``tpch_lineitem`` kind: TPC-H ``lineitem`` resident on the device,
served through ``repro_torch.serve.AQPSession``, every answer judged
against exact float64 answers of the seed's table.

The timed path is ``AQPSession.submit`` -> ``AQPSession.pump`` ->
``AQPSession.poll``.  A configuration that names no kind is of this one.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from aqpbench.data import lineitem
from aqpbench.reference import exact as ref_exact
from aqpbench.reference import judge as ref_judge
from aqpbench.traffic.generator import Traffic

# Limits a checks file may hold: those that must read 0, and those set
# between the sound runs' readings and the control's.
EXACT_LIMITS = ("unanswered", "overclaimed")
READ_LIMITS = ("miss_share", "far_share")


# -- build ------------------------------------------------------------------
def make_data(cell, seed: int, device):
    """The seed's table on ``device``, handed to the program as its
    resident ``GroupedData`` (values and group offsets, no sort)."""
    from repro_torch.core.sampling import GroupedData

    values, offsets = lineitem.make_table(cell.config, seed, device)
    return GroupedData(values, offsets, device=device)


def make_session(cell, data, seed: int):
    """The configuration's ``AQPSession`` over ``data``."""
    from repro_torch.serve import AQPSession

    s = cell.config["session"]
    session_seed = int(np.random.default_rng(
        lineitem.seed_words(seed) + [3]).integers(0, 2 ** 31 - 1))
    return AQPSession(data, B=s["B"], n_min=s["n_min"], n_max=s["n_max"],
                      max_iters=s["max_iters"], n_cap=s["n_cap"],
                      seed=session_seed, data_shards=s["data_shards"],
                      warm_cache=s["warm_cache"], degrade=s["degrade"])


def make_traffic(cell, data, seed: int) -> Traffic:
    """The requests of the cell's mix, sized by the seed's group sizes."""
    return Traffic(cell.mix, cell.config, np.diff(data.offsets), seed)


# -- client -----------------------------------------------------------------
class Client:
    """Sends the cell's requests into the session and records them."""

    def __init__(self, sess, device):
        from repro_torch.aqp.query import Query, Request
        self._Query, self._Request = Query, Request
        self.sess = sess
        self.device = device
        self.records: List[dict] = []
        self.outstanding: Dict[int, dict] = {}
        self.pump_s: List[float] = []

    def send(self, spec: dict, t_sent: float) -> dict:
        q = self._Query(func=spec["func"], epsilon=spec["epsilon"],
                        delta=spec["delta"], group_by=spec["group_by"])
        ticket = self.sess.submit(self._Request(query=q))
        rec = {"spec": spec, "ticket": ticket, "t_sent": t_sent,
               "t_done": None, "resp": None}
        self.outstanding[ticket.rid] = rec
        self.records.append(rec)
        return rec

    def pump(self) -> List[dict]:
        """One scheduler round, then every answer it finished."""
        t0 = time.perf_counter()
        self.sess.pump()
        t1 = time.perf_counter()
        self.pump_s.append(t1 - t0)
        done = []
        for rid in list(self.outstanding):
            r = self.sess.poll(self.outstanding[rid]["ticket"])
            if r is not None:
                rec = self.outstanding.pop(rid)
                rec["t_done"], rec["resp"] = t1, r
                done.append(rec)
        return done

    def idle_round(self) -> None:
        """A round with nothing queued: the planner resizes the pool to what
        it saw (it resizes only when the pool is idle)."""
        self.sess.pump()


# -- counters ---------------------------------------------------------------
def counters(sess) -> dict:
    st = sess.stats()
    return {"rows_touched": int(st["rows_touched"]),
            "fused_dispatches": int(st["fused_dispatches"]),
            "completed": int(st["completed"]),
            "pool_rebuilds": int(st["pool_rebuilds"])}


def describe(sess) -> str:
    pool = sess.stats().get("pool", {})
    return (f"pool: lanes {pool.get('lanes')}, ticks_per_sync "
            f"{pool.get('ticks_per_sync')}, rebuilds {sess.pool_rebuilds}, "
            f"peak queue {pool.get('peak_queue_depth')}")


# -- tracing ----------------------------------------------------------------
# The prefixes of the program's own spans (``repro_torch.core.trace``) and
# of this kind's ``layer_spans``.  Its kernels are rows 1 and 2, which every
# kind gets (``aqpbench/kernels.py``).
SPAN_PREFIXES = ("session.", "lane_pool.")


@contextlib.contextmanager
def layer_spans():
    """``record_function`` spans around the calls into each layer, set from
    the benchmark's side: the session's admission and synchronous routes,
    the pool's tick and harvests."""
    from torch.profiler import record_function
    from repro_torch.serve.lane_pool import LanePool
    from repro_torch.serve.session import AQPSession

    def wrap(owner, attr, name):
        fn = getattr(owner, attr)

        def spanned(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        setattr(owner, attr, spanned)
        return owner, attr, fn

    saved = [wrap(AQPSession, "_admit", "session.admit"),
             wrap(AQPSession, "_run_loop", "session.loop"),
             wrap(AQPSession, "_run_batched", "session.batched"),
             wrap(LanePool, "tick", "lane_pool.tick"),
             wrap(LanePool, "_harvest", "lane_pool.harvest"),
             wrap(LanePool, "_harvest_blocks", "lane_pool.harvest_blocks")]
    try:
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


# -- judging ----------------------------------------------------------------
def answer(resp) -> dict:
    """A ``SessionResponse`` as the reference reads it."""
    out = {"theta": np.ravel(np.asarray(resp.theta, np.float64)),
           "success": bool(resp.success), "error": float(resp.error)}
    if resp.group_by:
        out["group_error"] = np.asarray(resp.group_error, np.float64)
        out["group_success"] = np.asarray(resp.group_success, bool)
    return out


def judge(cell, seed: int, device, pending: list,
          log: Optional[Callable[[str], None]]) -> dict:
    """Every ``(spec, answer or None)`` of the run against the exact answers
    of the seed's table, made again from the seed."""
    exact = ref_exact.exact_answers(cell.config, seed, device,
                                    {spec["func"] for spec, _ in pending})
    verdict = ref_judge.judge(pending, exact, log=log)
    table = ref_judge.checks(verdict, cell.limits)
    return {"correct": ref_judge.passed(table) and verdict["units"] > 0,
            "failed": verdict["unanswered"] + verdict["unsuccessful"],
            "verdict": verdict, "checks": table}
