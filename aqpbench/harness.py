"""One run of one cell: build the deployment, warm up, drive the window,
judge every answer against the plain reference, print the result.

What is built, sent, counted and judged is the cell's kind's
(``kinds/<kind>.py``, found by name): its data and server from the seed,
its client and traffic, its counters, its spans and its reference.  This
module holds the order of a run, which every kind shares, driven from one
thread:

* open loop: each request is sent once it is due (Poisson arrivals), and
  its latency runs from the due time, so a stall delays the requests
  behind it too;
* closed loop: every client sends its next request as soon as its previous
  answer is polled; latency runs from the send.

The window sends requests for ``seconds``; afterwards nothing new is sent
and the server is pumped until every request sent in the window has its
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

from . import kernels
from .cell import Cell, reader, span_prefixes

GRACE_S = 60.0              # how long answers may come after the window
TRACE_SECONDS = 8.0         # the traced sub-window, after the window
WARMUP_STREAM, TRACED_STREAM = 10_000, 20_000   # queues of their own
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port must not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def drive(client, traffic, mix: dict, *, seconds: float,
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


def settle(client, grace_s: float) -> None:
    """Pump until every outstanding request is answered or ``grace_s``."""
    t_stop = time.perf_counter() + grace_s
    while client.outstanding and time.perf_counter() < t_stop:
        client.pump()


class Tracer:
    """The profiler over a sub-window of ``TRACE_SECONDS`` of the cell's
    traffic, driven once the measured window has drained, with the records
    and launch counts of every kernel of the kind (``kernels.of``) over the
    same interval.  The profiler starts before the sub-window's clock does,
    so its one-time start-up (seconds) lies outside both windows."""

    def __init__(self, device, kind):
        self.device = device
        self.spans = kind.layer_spans
        self.prefixes = span_prefixes(kind)     # the program's spans
        self.kernels = kernels.of(kind)
        self.length = TRACE_SECONDS
        self.span: Optional[tuple] = None       # (start, end) perf_counter
        self.calls: Dict[str, list] = {k: [] for k in self.kernels}
        self.launches: Dict[str, int] = {}
        self.prof = None

    def _counters(self):
        return {name: k.launches() for name, k in self.kernels.items()}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def record(self, client, traffic, mix: dict) -> None:
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
            stack.enter_context(self.spans())
            stack.enter_context(kernels.recording(self.kernels, self.calls))
            stack.enter_context(record_function(WINDOW))
            t0 = drive(client, traffic, mix, seconds=self.length,
                       first_stream=TRACED_STREAM)
        self.span = (t0, time.perf_counter())
        self._sync()
        after = self._counters()
        self.launches = {k: after[k] - v for k, v in before.items()}
        self.prof.stop()


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
    """The kind's deployment data, made on ``device`` from the seed."""
    return cell.kind.make_data(cell, seed, device)


def make_session(cell: Cell, data, seed: int):
    """The kind's server over ``data``: the program under test.  Runs call
    the kind's builders through these two names, so a profiler can wrap
    them."""
    return cell.kind.make_session(cell, data, seed)


def warm_up(client, traffic, mix: dict, grace_s: float) -> int:
    """Serve ``warmup_requests`` of the mix from streams of their own and
    drain them, then one idle round of the client (a TPC-H session's
    planner resizes the pool to what it saw only when the pool is idle).
    Returns the requests served."""
    drive(client, traffic, mix, seconds=float("inf"),
          first_stream=WARMUP_STREAM,
          limit=int(mix["warmup_requests"]))
    settle(client, grace_s)
    if client.outstanding:
        raise RuntimeError("the warm-up did not drain")
    client.idle_round()
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
    kind, mix = cell.kind, cell.mix
    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    t = time.perf_counter()
    prepare_kernels(device)
    t_build = time.perf_counter() - t
    data = make_data(cell, seed, device)
    sess = make_session(cell, data, seed)
    traffic = kind.make_traffic(cell, data, seed)
    del data
    client = kind.Client(sess, device)
    t = time.perf_counter()
    warm_n = warm_up(client, traffic, mix, grace_s)
    t_warm = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s (kernel libraries {t_build:.3f} s, "
        f"warm-up {t_warm:.3f} s over {warm_n} requests)")

    stats0 = kind.counters(sess)
    t0 = drive(client, traffic, mix, seconds=seconds, first_stream=0)
    t_end = t0 + seconds
    pumps_in_window = len(client.pump_s)
    settle(client, grace_s)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_settled = time.perf_counter()
    stats1 = kind.counters(sess)
    records = list(client.records)
    tracer = None
    if trace:
        tracer = Tracer(device, kind)
        tracer.record(client, traffic, mix)
        settle(client, grace_s)
    log(kind.describe(sess))

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
                else kind.answer(r["resp"])) for r in client.records]
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
    judged = kind.judge(cell, seed, device, pending, log)
    log(f"reference {time.perf_counter() - t:.3f} s: {judged['verdict']}")

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        dev["power"] = power_limit()
    out = {"correct": bool(judged["correct"]), "attempted": len(pending),
           "failed": judged["failed"]}
    if trace:
        from . import devtrace
        t = time.perf_counter()
        # ``read(prof)`` where the kind keeps the default prefixes, so that
        # a wrapper of that call (``profile_serve.py --spans``) still fits.
        run["trace"] = (
            devtrace.read(tracer.prof)
            if tracer.prefixes == devtrace.DEFAULT_PREFIXES
            else devtrace.read(tracer.prof, tracer.prefixes))
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
            events = ", ".join(f"{name} {tr.kernel(k.events[0])[0]}"
                               for name, k in tracer.kernels.items())
            log(f"trace {time.perf_counter() - t:.3f} s: {len(tr.names)} "
                f"device ops, launches counted {tracer.launches}, "
                f"kernel events {events}")
    else:
        metrics = {m["name"]: {"value": (setup_s if m["name"] == "setup_s"
                                         else end_to_end(m["name"], run)),
                               "unit": m["unit"]} for m in cell.end_to_end}
    out["metrics"] = metrics
    out["device"] = dev
    out["checks"] = judged["checks"]
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
