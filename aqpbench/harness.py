"""One run of one cell: make the table, build the session, warm up, drive the
window, judge every answer against the plain reference, print the result.

The timed path is ``AQPSession.submit`` -> ``AQPSession.pump`` ->
``AQPSession.poll`` of ``repro_torch.serve.session``, driven from one thread:

* open loop: each request is submitted once it is due (Poisson arrivals),
  and its latency runs from the due time, so a stall delays the requests
  behind it too;
* closed loop: every client sends its next request as soon as its previous
  answer is polled; latency runs from the send.

The window sends requests for ``seconds``; afterwards nothing new is sent
and the session is pumped until every request sent in the window has its
answer, or a minute has passed.  Latencies are those of every request sent
in the window (one never answered counts its wait until then);
``answers_per_s`` counts the answers polled inside the window.

A traced run measures the same window with nothing traced, so its host-clock
and counter metrics read as an untraced run's.  Once the window has drained,
the profiler starts, then a sub-window of ``TRACE_SECONDS`` of the same
traffic is recorded and drained: the device metrics come from it.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .cell import Cell, reader
from .data import lineitem
from .reference import exact as ref_exact
from .reference import judge as ref_judge
from .traffic.generator import Traffic

GRACE_S = 60.0              # how long answers may come after the window
TRACE_SECONDS = 8.0         # the traced sub-window, after the window
WARMUP_STREAM, TRACED_STREAM = 10_000, 20_000   # queues of their own
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


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


def drive(client: Client, traffic: Traffic, mix: dict, *, seconds: float,
          first_stream: int, limit: Optional[int] = None) -> float:
    """Send the mix for ``seconds`` (or ``limit`` requests) from queue
    ``first_stream``; returns the window's start."""
    t0 = time.perf_counter()
    t_end = t0 + seconds
    if mix["loop"] == "open":
        plan = traffic.arrivals(seconds, stream=first_stream, limit=limit)
        i = 0
        while True:
            now = time.perf_counter()
            if now >= t_end or (limit is not None and i >= len(plan)):
                break
            while i < len(plan) and t0 + plan[i][0] <= now:
                client.send(plan[i][1], t0 + plan[i][0])
                i += 1
            if client.outstanding:
                client.pump()
            else:
                nxt = t0 + plan[i][0] if i < len(plan) else t_end
                time.sleep(max(min(nxt, t_end) - now, 0.0))
        return t0
    queue = traffic.stream(first_stream)
    sent = 0
    for _ in range(int(mix["clients"])):
        if limit is None or sent < limit:
            client.send(next(queue), t0)
            sent += 1
    while True:
        now = time.perf_counter()
        if now >= t_end or (limit is not None and not client.outstanding):
            break
        for _ in client.pump():
            now = time.perf_counter()
            if now < t_end and (limit is None or sent < limit):
                client.send(next(queue), now)
                sent += 1
    return t0


def settle(client: Client, grace_s: float) -> None:
    """Pump until every outstanding request is answered or ``grace_s``."""
    t_stop = time.perf_counter() + grace_s
    while client.outstanding and time.perf_counter() < t_stop:
        client.pump()


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


@contextlib.contextmanager
def kernel_calls(calls: Dict[str, list]):
    """Record each bootstrap kernel call's shapes and, on the device with
    no sync, its live rows: the work ``roofline/work.py`` counts."""
    from repro_torch.kernels.poisson_bootstrap import ops as pb_ops
    from repro_torch.kernels.segment_agg import ops as seg_ops

    pb, seg = pb_ops.bootstrap_moments_masked, seg_ops.segment_bootstrap_sorted

    def rec_pb(x, mask, seeds, B, *, lane_active=None):
        live = mask != 0
        gate = 0
        if lane_active is not None:
            live = live & lane_active.bool()[..., None]
            gate = 1 if lane_active.dtype == torch.bool else 4
        groups = x.numel() // max(x.shape[-1], 1)
        calls["poisson_bootstrap"].append(
            (groups, x.shape[-1], int(B), gate, live.sum()))
        return pb(x, mask, seeds, B, lane_active=lane_active)

    def rec_seg(x, mask, slot, seed, lane_off, B, n_slots):
        calls["segment_boot"].append(
            (x.shape[0], lane_off.shape[0] - 1, int(B), (mask > 0).sum()))
        return seg(x, mask, slot, seed, lane_off, B, n_slots)

    pb_ops.bootstrap_moments_masked = rec_pb
    seg_ops.segment_bootstrap_sorted = rec_seg
    try:
        yield
    finally:
        pb_ops.bootstrap_moments_masked = pb
        seg_ops.segment_bootstrap_sorted = seg


class Tracer:
    """The profiler over a sub-window of ``TRACE_SECONDS`` of the cell's
    traffic, driven once the measured window has drained, with the
    kernel-call records of the same interval.  The profiler starts before
    the sub-window's clock does, so its one-time start-up (seconds) lies
    outside both windows."""

    def __init__(self, device):
        self.device = device
        self.length = TRACE_SECONDS
        self.span: Optional[tuple] = None       # (start, end) perf_counter
        self.calls: Dict[str, list] = {"poisson_bootstrap": [],
                                       "segment_boot": []}
        self.launches: Dict[str, int] = {}
        self.prof = None

    def _counters(self):
        from repro_torch.kernels.poisson_bootstrap import ops as pb_ops
        from repro_torch.kernels.segment_agg import ops as seg_ops
        return {"poisson_bootstrap": pb_ops.counter.launches,
                "segment_boot": seg_ops.boot_counter.launches}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def record(self, client: Client, traffic: Traffic, mix: dict) -> None:
        """Start the profiler, drive the sub-window from a queue of its
        own, stop the profiler."""
        from torch.profiler import ProfilerActivity, profile, record_function
        from .devtrace import WINDOW
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._sync()
        before = self._counters()
        with contextlib.ExitStack() as stack:
            stack.enter_context(layer_spans())
            stack.enter_context(kernel_calls(self.calls))
            stack.enter_context(record_function(WINDOW))
            t0 = drive(client, traffic, mix, seconds=self.length,
                       first_stream=TRACED_STREAM)
        self.span = (t0, time.perf_counter())
        self._sync()
        after = self._counters()
        self.launches = {k: after[k] - v for k, v in before.items()}
        self.prof.stop()


def _response_dict(r) -> dict:
    out = {"theta": np.ravel(np.asarray(r.theta, np.float64)),
           "success": bool(r.success), "error": float(r.error)}
    if r.group_by:
        out["group_error"] = np.asarray(r.group_error, np.float64)
        out["group_success"] = np.asarray(r.group_success, bool)
    return out


def _stats(sess) -> dict:
    st = sess.stats()
    return {"rows_touched": int(st["rows_touched"]),
            "fused_dispatches": int(st["fused_dispatches"]),
            "completed": int(st["completed"]),
            "pool_rebuilds": int(st["pool_rebuilds"])}


def power_limit() -> Optional[str]:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def make_data(cell: Cell, seed: int, device):
    """The seed's table on ``device``, handed to the program as its
    resident ``GroupedData`` (values and group offsets, no sort)."""
    from repro_torch.core.sampling import GroupedData

    values, offsets = lineitem.make_table(cell.config, seed, device)
    return GroupedData(values, offsets, device=device)


def make_session(cell: Cell, data, seed: int):
    """The configuration's ``AQPSession`` over ``data``."""
    from repro_torch.serve import AQPSession

    s = cell.config["session"]
    session_seed = int(np.random.default_rng(
        lineitem.seed_words(seed) + [3]).integers(0, 2 ** 31 - 1))
    return AQPSession(data, B=s["B"], n_min=s["n_min"], n_max=s["n_max"],
                      max_iters=s["max_iters"], n_cap=s["n_cap"],
                      seed=session_seed, data_shards=s["data_shards"],
                      warm_cache=s["warm_cache"], degrade=s["degrade"])


def warm_up(client: Client, traffic: Traffic, mix: dict,
            grace_s: float) -> int:
    """Serve ``warmup_requests`` of the mix from streams of their own and
    drain them; one more idle round lets the planner resize the pool to
    what it saw (it resizes only when the pool is idle).  Returns the
    requests served."""
    drive(client, traffic, mix, seconds=float("inf"),
          first_stream=WARMUP_STREAM,
          limit=int(mix["warmup_requests"]))
    settle(client, grace_s)
    if client.outstanding:
        raise RuntimeError("the warm-up did not drain")
    client.sess.pump()
    if client.device.type == "cuda":
        torch.cuda.synchronize(client.device)
    n = len(client.records)
    client.records.clear()
    client.pump_s.clear()
    return n


def prepare_kernels(device) -> None:
    """Build (first run of a checkout only) and load the CUDA libraries."""
    if device.type != "cuda":
        return
    from repro_torch.kernels.poisson_bootstrap import ops as pb_ops
    from repro_torch.kernels.segment_agg import ops as seg_ops
    pb_ops.library()
    seg_ops.library()


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, grace_s: float = GRACE_S) -> dict:
    """One run; returns the result object the command prints."""
    device = torch.device(device)
    cfg, mix = cell.config, cell.mix
    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    t = time.perf_counter()
    prepare_kernels(device)
    t_build = time.perf_counter() - t
    data = make_data(cell, seed, device)
    sess = make_session(cell, data, seed)
    offsets = data.offsets
    del data
    traffic = Traffic(mix, cfg, np.diff(offsets), seed)
    client = Client(sess, device)
    t = time.perf_counter()
    warm_n = warm_up(client, traffic, mix, grace_s)
    t_warm = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s (kernel libraries {t_build:.3f} s, "
        f"warm-up {t_warm:.3f} s over {warm_n} requests)")

    stats0 = _stats(sess)
    t0 = drive(client, traffic, mix, seconds=seconds, first_stream=0)
    t_end = t0 + seconds
    pumps_in_window = len(client.pump_s)
    settle(client, grace_s)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_settled = time.perf_counter()
    stats1 = _stats(sess)
    records = list(client.records)
    tracer = None
    if trace:
        tracer = Tracer(device)
        tracer.record(client, traffic, mix)
        settle(client, grace_s)
    pool = sess.stats().get("pool", {})
    log(f"pool: lanes {pool.get('lanes')}, ticks_per_sync "
        f"{pool.get('ticks_per_sync')}, rebuilds {sess.pool_rebuilds}, "
        f"peak queue {pool.get('peak_queue_depth')}")

    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded in the measuring process: {found}")
        raise SystemExit(3)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    answered = [r for r in records if r["resp"] is not None]
    in_window = [r for r in answered if r["t_done"] <= t_end]
    traced = client.records[len(records):]
    # An answer that never came waited until the grace ran out.
    lat = np.asarray([(r["t_done"] if r["resp"] is not None else t_settled)
                      - r["t_sent"] for r in records])
    pending = [(r["spec"], None if r["resp"] is None
                else _response_dict(r["resp"])) for r in client.records]
    run = {
        "seconds": seconds, "t0": t0, "t_end": t_end,
        "records": records, "answered": answered, "in_window": in_window,
        "latency_s": lat, "pump_s": client.pump_s[:pumps_in_window],
        "stats0": stats0, "stats1": stats1,
        "tracer": tracer,
        "traced": [r for r in traced if r["resp"] is not None],
    }
    if tracer is not None:
        lo, hi = tracer.span
        n = sum(1 for r in traced if r["resp"] is not None
                and r["t_done"] <= hi)
        log(f"traced sub-window: {n} answers in {hi - lo:.3f} s "
            f"({n / (hi - lo):.3f}/s) against {len(in_window) / seconds:.3f}"
            f"/s in the window")
    # Free the program's state before the reference runs.
    del sess, client
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    exact = ref_exact.exact_answers(cfg, seed, device,
                                    {spec["func"] for spec, _ in pending})
    verdict = ref_judge.judge(pending, exact, log=log)
    table = ref_judge.checks(verdict, cell.limits)
    correct = ref_judge.passed(table) and verdict["units"] > 0
    log(f"reference {time.perf_counter() - t:.3f} s: {verdict}")

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power"] = power_limit()
    out = {"correct": bool(correct), "attempted": len(pending),
           "failed": verdict["unanswered"] + verdict["unsuccessful"]}
    if trace:
        from . import devtrace
        t = time.perf_counter()
        run["trace"] = devtrace.read(tracer.prof)
        metrics = {}
        for m in cell.per_layer:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = run["trace"]
        if tr is not None:
            dev["busy_s"] = tr.busy_s()
            dev["window_s"] = tr.window_s
            out["breakdown"] = {"device_ops": tr.top_ops(),
                                "idle_gaps": tr.idle_gaps()}
            log(f"trace {time.perf_counter() - t:.3f} s: {len(tr.names)} "
                f"device ops, launches counted {tracer.launches}, "
                f"kernel events {tr.kernel('pb_kernel')[0]} pb / "
                f"{tr.kernel('seg_boot_kernel')[0]} seg")
    else:
        metrics = {m["name"]: {"value": (setup_s if m["name"] == "setup_s"
                                         else end_to_end(m["name"], run)),
                               "unit": m["unit"]} for m in cell.end_to_end}
    out["metrics"] = metrics
    out["device"] = dev
    out["checks"] = table
    return out


def end_to_end(name: str, run: dict) -> float:
    """The end-to-end metrics, on the host clock, over the window."""
    lat = run["latency_s"]
    n = len(run["answered"])
    if name == "answer_p95_ms":
        return float(np.percentile(lat, 95)) * 1e3
    if name == "answer_p50_ms":
        return float(np.percentile(lat, 50)) * 1e3
    if name == "answers_per_s":
        return len(run["in_window"]) / run["seconds"]
    if name == "rows_per_answer":
        return (run["stats1"]["rows_touched"]
                - run["stats0"]["rows_touched"]) / max(n, 1)
    raise ValueError(f"no end-to-end metric {name!r}")
