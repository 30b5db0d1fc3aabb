#!/usr/bin/env python3
"""Where a serve run's time goes on the card.

Runs one of ``chip_smoke.py``'s serve phases once to warm up, then once
more under ``torch.profiler``, and prints the wall time, the device busy
share (the union of the device's busy intervals over the profiled window,
read by ``aqpbench/devtrace.py``, which leaves out the device-side copies of
the program's spans), and the top device and host ops.  The solo and
grouped serves of the pool are measured by the benchmark's cells
(``aqpbench/run.py --trace 1``).  The phases (TPC-H lineitem SF10 resident
on the card):

* ``--sharded``: 16 avg/sum/var/std requests, GROUP BY SHIPINSTRUCT,
  through a forced-POOL sharded session (``data_shards=4, mesh=False``),
  ``chip_smoke.py`` phase 18's pool;
* ``--host``: the host serve of ``chip_smoke.py`` phase 14, its 12
  requests on the HOST route (auto planner) and the engine's exact answers
  of the moment requests, GROUP BY SHIPINSTRUCT; it also prints the
  segment-aggregate kernel's share of device time;
* ``--warm``: ``chip_smoke.py`` phase 16(a)'s solo waves, GROUP BY
  SHIPINSTRUCT: a warm-cache session answers the 16 requests cold
  (outside the profile), then the profile covers their exact repeats and
  their near repeats at epsilon / 1.1 on the WARM route;
* ``--lm``: the LM serve of ``chip_smoke.py`` phase 12 (Qwen2-1.5B bf16 at
  full width, 16 requests through a ``ContinuousBatcher`` of 8 slots), then
  four lone decode steps of the 8-slot pool for the kernels per decode
  step; it also prints the decode-attention kernel's share of device time.
* ``--decode [TREE ...]``: the decode-attention kernel alone, timed as
  ``chip_smoke.py`` phase 9 times it (CUDA graphs of 64 calls over 8
  rotating caches at the serve's, full and short lengths, against SDPA and
  the byte bound), once for each checkout TREE in the order given (this one
  by default), each in its own process with its own build: to compare two
  versions of the kernel on one card, list them as A B B A.
* ``--train``: ``chip_smoke.py`` phase 24(b)'s training step (Qwen2-1.5B
  bf16 at full width, 8 x 512 pipeline tokens): the step time under each
  remat policy (none, "dots", "full"), the "dots" step split into its
  forward and backward and its AdamW update (CUDA events), then one step
  under the profiler (device busy share, kernels, top ops); no kernel of
  the port lies on this path.
* ``--boot [TREE ...]``: the two bootstrap kernels alone, on
  ``chip_smoke.py``'s phase 2 and phase 3 sets (every width rung and the
  stacked init probes; every stream-length rung, phase 8's L = 9000 stream
  and the grouped serve's own streams), each from a CUDA graph of 20
  calls, once for each checkout TREE as ``--decode`` does.
* ``--spans WORKLOAD SEED``: one traced run of a benchmark cell
  (``aqpbench/run.py --trace 1`` at ``run_seconds``), then its traced
  sub-window by the program's innermost span: idle device seconds (as
  ``DeviceTrace.idle_gaps``), and each device operation's launches and
  device seconds put down to the innermost span around its launch call,
  found through the profiler's launch correlation, with the ATen op that
  launched it; and the clock check (no operation starts before its launch
  call).  It also prints the session's graph counters
  (``graph_captures``, ``graph_replays``, ``eager_pre_read``,
  ``finish_captures``, ``finish_replays``, ``eager_finish``,
  ``pool_rebuilds``) over the warm-up, the window and the traced
  sub-window, and the sub-window's ``lane_pool.step.fit_predict`` phases
  by the step or session route around them, with those that replay or
  capture.  With a path, the table and the run's result are written there
  as JSON.

The sharded, host and warm profiles print each bootstrap kernel's share of
the device time.  Run from the root of a checkout on a machine with a CUDA
card: ``python3 profile_serve.py --sharded | --host | --warm | --lm |
--train | --decode [TREE ...] | --boot [TREE ...] | --spans WORKLOAD SEED
[TRACE.json]``; with a path, the Chrome trace is written there.
"""
import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from aqpbench import devtrace  # noqa: E402
from chip_smoke import (LM_ARCH, LM_S_MAX, LM_SLOTS, N_CAP,  # noqa: E402
                        N_MAX, SERVE, TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ,
                        fail, host_requests, lm_requests, nvidia_smi,
                        run_lm_serve, serve_requests)


def serve_once(data, reqs) -> None:
    """The requests through a forced-POOL session of 4 row shards on one
    device (phase 18's pool)."""
    from repro_torch.aqp.query import Query, Request
    from repro_torch.serve import AQPSession, Planner, Route

    sess = AQPSession(data, data_shards=4, mesh=False,
                      planner=Planner(mode=Route.POOL, pool_lanes=8,
                                      data_shards=4), **SERVE)
    t0 = time.perf_counter()
    for f, e, g in reqs:
        sess.submit(Request(query=Query(func=f, epsilon=e, group_by=g)))
    res = sess.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(res) != len(reqs) or not all(r.success for r in res):
        fail("a profiled request failed")
    st = sess.stats()
    print(f"  wall {wall * 1e3:.1f} ms, pool ticks {st['pool']['ticks']}, "
          f"dispatches {st['fused_dispatches']}, block ticks "
          f"{st['pool']['block_ticks']}")


def host_once(data, reqs) -> None:
    """Phase 14's requests through a fresh session on the HOST route, then
    the engine's exact answers of the moment requests."""
    from repro_torch.aqp.query import Query, Request
    from repro_torch.serve import AQPSession

    sess = AQPSession(data, **SERVE)
    queries = [Query(**kw) for _, kw, _, _ in reqs]
    t0 = time.perf_counter()
    for q in queries:
        sess.submit(Request(query=q))
    res = sess.drain()
    for q in queries:
        if q.func not in ("median", "maxq"):
            sess.engine.exact(q)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(res) != len(reqs) or not all(r.success for r in res):
        fail("a profiled request failed")
    st = sess.stats()
    print(f"  wall {wall * 1e3:.1f} ms, rows touched {st['rows_touched']} "
          f"(store {st['store_rows']}, fused {st['fused_rows']})")


def warm_once(data, reqs, measured) -> None:
    """Phase 16(a)'s solo waves: the requests cold, then, inside
    ``measured`` (a context manager), their exact repeats and their near
    repeats at epsilon / 1.1."""
    from repro_torch.aqp.query import Query, Request
    from repro_torch.serve import AQPSession, Planner, Route

    sess = AQPSession(data, warm_cache=True,
                      planner=Planner(mode=Route.POOL, pool_lanes=8),
                      **SERVE)
    for f, e, _ in reqs:
        sess.submit(Request(query=Query(func=f, epsilon=e)))
    sess.drain()
    d0 = sess.fused_dispatches
    with measured:
        t0 = time.perf_counter()
        for div in (1.0, 1.1):
            for f, e, _ in reqs:
                sess.submit(Request(query=Query(func=f, epsilon=e / div)))
        res = sess.drain()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if len(res) != 2 * len(reqs) or not all(
            r.success and r.route is Route.WARM for r in res):
        fail("a profiled warm request failed or missed the WARM route")
    st = sess.stats()
    print(f"  wall {wall * 1e3:.1f} ms for {len(res)} warm requests, "
          f"dispatches {sess.fused_dispatches - d0}, exact hits "
          f"{st['warm_cache']['exact_hits']}, warm lanes spliced "
          f"{st['pool']['warm_spliced']}, warm_verify_failures "
          f"{st['warm_verify_failures']}")


def profiler():
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


@contextlib.contextmanager
def window(prof):
    """Profile the block with ``prof``, marked as the window that
    :func:`device_summary` reads."""
    with prof, record_function(devtrace.WINDOW):
        yield prof


def device_summary(prof, what: str):
    """The device's busy time (the union of its busy intervals, so
    overlapping operations count once) over the profiled window, and the
    device operations that started in it; returns the profile's
    ``key_averages()`` and its :class:`devtrace.DeviceTrace`."""
    tr = devtrace.read(prof)
    if tr is None:
        fail("the profile has no window span")
    busy, wall = tr.busy_s(), tr.window_s
    print(f"  {what}: device busy {busy * 1e3:.2f} ms of {wall * 1e3:.1f} "
          f"ms window: busy share {busy / wall:.3f}, idle share "
          f"{1 - busy / wall:.3f}; {tr.count_in_window()} device ops")
    return prof.key_averages(), tr


NO_SPAN = "host:outside spans"
# Idle labels that name no phase of the serving loop.
NO_PHASE = (NO_SPAN, "session.pump", "lane_pool.tick")


def _innermost(spans, points):
    """The name of the innermost of the properly nested ``spans`` (name,
    start, end) around each of ``points``, or :data:`NO_SPAN`."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1],
                                                     -spans[i][2]))
    out = [NO_SPAN] * len(points)
    stack, j = [], 0
    for qi in sorted(range(len(points)), key=points.__getitem__):
        t = points[qi]
        while j < len(order) and spans[order[j]][1] <= t:
            start = spans[order[j]][1]
            while stack and spans[stack[-1]][2] < start:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and spans[stack[-1]][2] < t:
            stack.pop()
        if stack:
            out[qi] = spans[stack[-1]][0]
    return out


def span_table(prof, tr) -> dict:
    """The traced window by launching span: idle seconds, device ops
    launched and their device seconds, the top device ops by launching span
    and ATen op, and the clock check."""
    from collections import Counter, defaultdict

    cuda = torch.autograd.DeviceType.CUDA
    lo, hi = tr.window
    runtime, cpu_ops, device = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if e.duration_ns() > 0 and not name.startswith(
                    devtrace.SPANS) and lo <= e.start_ns() < hi:
                device.append(e)
        elif name.startswith("cu"):          # CUDA runtime/driver calls
            runtime[e.correlation_id()] = e
        elif name.startswith("aten::"):
            cpu_ops[e.correlation_id()] = e
    launch, via, aten = [], Counter(), []
    for e in device:
        r = runtime.get(e.correlation_id())
        op = cpu_ops.get(e.linked_correlation_id())
        if r is not None:
            launch.append(r.start_ns())
            via["runtime call"] += 1
            op = op or cpu_ops.get(r.linked_correlation_id())
        elif op is not None:
            launch.append(op.start_ns())
            via["ATen op"] += 1
        else:
            launch.append(e.start_ns())
            via["none (own start)"] += 1
        aten.append(op.name() if op is not None else "-")
    where = _innermost(tr.spans, launch)
    by_span = defaultdict(lambda: [0.0, 0, 0.0])
    for name, t in tr.idle_gaps(len(tr.spans) + 1):
        by_span[name][0] += t
    top = defaultdict(float)
    for e, sp, op in zip(device, where, aten):
        d = e.duration_ns() * 1e-9
        by_span[sp][1] += 1
        by_span[sp][2] += d
        top[(e.name()[:60], sp, op)] += d
    offsets = np.asarray([e.start_ns() - t for e, t in zip(device, launch)],
                         np.int64)
    # How the offsets run over the window: a constant shift of the device
    # clock against the host's, or a drift.
    tenth = np.minimum((np.asarray(launch, np.int64) - lo) * 10
                       // max(hi - lo, 1), 9)
    drift = [int(np.median(offsets[tenth == i])) if (tenth == i).any()
             else None for i in range(10)]
    by_kernel = defaultdict(lambda: [defaultdict(float), defaultdict(float)])
    for (name, sp, op), d in top.items():
        by_kernel[name][0][sp] += d
        by_kernel[name][1][op] += d
    heavy = sorted(by_kernel, key=lambda k: -sum(by_kernel[k][0].values()))
    idle = sum(v[0] for v in by_span.values())
    rows = sorted(([k] + v for k, v in by_span.items()),
                  key=lambda r: -r[1])
    return {
        "window_s": tr.window_s, "busy_s": tr.busy_s(), "idle_s": idle,
        "idle_no_phase_share": sum(v[0] for k, v in by_span.items()
                                   if k in NO_PHASE) / max(idle, 1e-12),
        "rows": rows,
        "top_ops": [[*k, v] for k, v in sorted(top.items(),
                                                key=lambda kv: -kv[1])[:25]],
        "by_kernel": {k: [sorted(by_kernel[k][0].items(),
                                 key=lambda kv: -kv[1]),
                          sorted(by_kernel[k][1].items(),
                                 key=lambda kv: -kv[1])[:10]]
                      for k in heavy[:3]},
        "launch_found_by": dict(via),
        "worst_start_after_launch_ns": (int(offsets.min()) if offsets.size
                                        else None),
        "ops_starting_before_launch": int((offsets < 0).sum()),
        "start_after_launch_quantiles_ns": (
            [int(x) for x in np.quantile(offsets, [0, 0.01, 0.1, 0.5])]
            if offsets.size else None),
        "median_offset_by_tenth_of_window_ns": drift,
    }


GRAPH_COUNTERS = ("graph_captures", "graph_replays", "eager_pre_read",
                  "finish_captures", "finish_replays", "eager_finish",
                  "pool_rebuilds")
PHASE_ROUTES = ("lane_pool.tier_step", "lane_pool.block_step",
                "session.loop", "session.batched")


def phase_routes(tr) -> dict:
    """The traced sub-window's ``lane_pool.step.fit_predict`` phases by
    the innermost of :data:`PHASE_ROUTES` around them, each with the count
    of them that hold a ``lane_pool.step.replay`` or a ``.capture``."""
    lo, hi = tr.window
    routes = [sp for sp in tr.spans if sp[0] in PHASE_ROUTES]
    phases = sorted(sp[1:] for sp in tr.spans
                    if sp[0] == "lane_pool.step.fit_predict"
                    and lo <= sp[1] < hi)
    starts = np.asarray([a for a, _ in phases], np.int64)
    ends = np.asarray([b for _, b in phases], np.int64)
    held = {}
    for kind in ("replay", "capture"):
        # Phases do not nest in one another: a mark lies in the last phase
        # that starts before it, or in none.
        t = np.asarray([sp[1] for sp in tr.spans
                        if sp[0] == f"lane_pool.step.{kind}"], np.int64)
        i = np.searchsorted(starts, t, side="right") - 1
        ok = (i >= 0) & (ends[np.maximum(i, 0)] >= t) if starts.size else \
            np.zeros(t.shape, bool)
        held[kind] = set(i[ok].tolist())
    table = {}
    for i, route in enumerate(_innermost(routes, starts.tolist())):
        row = table.setdefault(route, {"phases": 0, "replay": 0,
                                       "capture": 0})
        row["phases"] += 1
        for kind in ("replay", "capture"):
            row[kind] += i in held[kind]
    return table


def profile_spans(workload: str, seed: int, dest=None) -> None:
    """One traced run of ``workload``, its :func:`span_table`, the
    session's graph counters by stage and the sub-window's
    :func:`phase_routes`, written to ``dest`` as JSON when given."""
    import json as _json
    import weakref
    from aqpbench import harness
    from aqpbench.cell import load_cell

    seen, counts = {}, []
    read = devtrace.read
    make_session, drive, settle = (harness.make_session, harness.drive,
                                   harness.settle)
    stage = {0: "window", harness.WARMUP_STREAM: "warm-up",
             harness.TRACED_STREAM: "traced"}

    def keep(prof):
        seen["prof"], seen["tr"] = prof, read(prof)
        return seen["tr"]

    def snap(what):
        st = seen["sess"]().stats()
        counts.append((what, {k: int(st.get(k, -1))
                              for k in GRAPH_COUNTERS}))

    def kept_session(*a, **k):
        sess = make_session(*a, **k)
        seen["sess"] = weakref.ref(sess)
        snap("start")
        return sess

    def counted_drive(*a, first_stream, **k):
        seen["stage"] = stage.get(first_stream, str(first_stream))
        snap(f"{seen['stage']} starts")
        return drive(*a, first_stream=first_stream, **k)

    def counted_settle(*a, **k):
        settle(*a, **k)
        snap(f"{seen['stage']} drained")

    manifest = _json.loads((ROOT / "BENCHMARK.json").read_text())
    devtrace.read = keep
    harness.make_session = kept_session
    harness.drive, harness.settle = counted_drive, counted_settle
    try:
        out = harness.run_cell(load_cell(workload), seed,
                               float(manifest["run_seconds"]), True,
                               torch.device("cuda", 0), time.perf_counter())
    finally:
        devtrace.read = read
        harness.make_session = make_session
        harness.drive, harness.settle = drive, settle
    print(_json.dumps(out, default=str), flush=True)
    print("session graph counters by stage: " + "; ".join(
        f"{what} {c}" for what, c in counts))
    routes = phase_routes(seen["tr"])
    print("sub-window fit_predict phases by route: " + "; ".join(
        f"{k} {v}" for k, v in sorted(routes.items())))
    table = span_table(seen["prof"], seen["tr"])
    table["graph_counters"] = counts
    table["phase_routes"] = routes
    print(f"{workload} seed {seed}: correct {out['correct']}, window "
          f"{table['window_s']:.3f} s, busy {table['busy_s']:.4f} s, idle "
          f"{table['idle_s']:.3f} s, of it with no phase label "
          f"{table['idle_no_phase_share']:.4f}")
    print("launching span | idle s | device ops | device s")
    for name, idle, n, dev in table["rows"]:
        print(f"{name} | {idle:.4f} | {n} | {dev:.5f}")
    print("device op | launching span | ATen op | device s")
    for name, sp, op, dev in table["top_ops"]:
        print(f"{name} | {sp} | {op} | {dev:.5f}")
    for name, (spans, ops) in table["by_kernel"].items():
        print(f"{name}: by span {spans}; by ATen op {ops}")
    print(f"start after launch, quantiles 0/1/10/50 % "
          f"{table['start_after_launch_quantiles_ns']} ns, median by tenth "
          f"of the window {table['median_offset_by_tenth_of_window_ns']}")
    print(f"launch found by {table['launch_found_by']}; worst start after "
          f"launch {table['worst_start_after_launch_ns']} ns; ops starting "
          f"before their launch {table['ops_starting_before_launch']}")
    if dest:
        dest = Path(dest)
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text(_json.dumps({"table": table, "result": out},
                                    default=str))


def profile_lm(trace) -> None:
    """The LM serve under the profiler, then four lone decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.models import model as M

    da_ops.library()
    cfg = get_config(LM_ARCH)
    params = M.init_model(cfg, seed=0, device="cuda")
    prompts = lm_requests(cfg)
    print("warm-up run")
    run_lm_serve(cfg, params, prompts[:2])
    print("profiled run")
    with window(profiler()) as prof:
        st = run_lm_serve(cfg, params, prompts)
    steps = st["steps"]
    print(f"  {len(st['done'])} requests, {steps} decode steps, "
          f"{len(st['splice_s'])} prefills, wall {st['wall'] * 1e3:.1f} ms")
    events, tr = device_summary(prof, "serve")
    da_n, da_s = tr.kernel("decode_attn")
    calls = cfg.n_layers * steps
    print(f"  decode attention: {calls} calls ran {da_n} device kernels, "
          f"{da_s * 1e3:.3f} ms = {da_s / max(tr.busy_s(), 1e-12):.4f} of "
          f"device time ({da_s * 1e6 / max(calls, 1):.2f} us a call)")
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    if trace:
        trace = Path(trace)
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))
    # Lone decode steps of the full pool at the serve's mean length.
    n = 4
    caches = M.init_caches(cfg, LM_SLOTS, LM_S_MAX, length=600,
                           device="cuda")
    tok = torch.zeros((LM_SLOTS, 1), dtype=torch.long, device="cuda")
    _, caches = M.decode_step(cfg, params, tok, caches)
    torch.cuda.synchronize()
    with window(profiler()) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            _, caches = M.decode_step(cfg, params, tok, caches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _, tr = device_summary(prof, f"{n} lone decode steps")
    print(f"  per decode step: {tr.count_in_window() / n:.0f} device ops, "
          f"device busy {tr.busy_s() / n * 1e3:.3f} ms, wall "
          f"{wall / n * 1e3:.3f} ms")


def _events_ms(fn, n: int) -> float:
    """Mean CUDA-event milliseconds of ``n`` calls of ``fn`` (after
    one)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def profile_train(trace) -> None:
    """Phase 24(b)'s step: remat policies, its parts, one profiled step."""
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.models import model as M
    from repro_torch.train import pytree
    from repro_torch.train.optimizer import AdamWConfig, adamw_update
    from repro_torch.train.train_step import TrainConfig, build_train_step

    cfg = get_config(TRAIN_ARCH)
    opt = AdamWConfig(lr_peak=1e-3, warmup_steps=5, total_steps=10)
    batch = pipeline.batch_for_step(0, global_batch=TRAIN_BATCH,
                                    seq_len=TRAIN_SEQ, vocab=cfg.vocab_size,
                                    device="cuda")
    init_fn, _ = build_train_step(cfg, TrainConfig(optimizer=opt))
    state = list(init_fn(0, "cuda"))
    for remat in (None, "full", "dots"):
        _, step = build_train_step(cfg, TrainConfig(optimizer=opt,
                                                    remat=remat))

        def one():
            state[:2] = step(state[0], state[1], batch)[:2]
        torch.cuda.reset_peak_memory_stats()
        ms = _events_ms(one, 3)
        print(f"  remat {remat}: step {ms:.1f} ms, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    params, opt_state = state
    flat, skel = pytree.flatten(M.trainable(params))
    grads = []

    def fwd_bwd():
        leaves = [t.detach().requires_grad_(True) for t in flat]
        loss = M.loss_fn(cfg, pytree.unflatten(skel, leaves), batch,
                         remat="dots")
        grads[:] = torch.autograd.grad(loss, leaves)
    fb = _events_ms(fwd_bwd, 3)
    g = pytree.unflatten(skel, grads)
    up = _events_ms(lambda: adamw_update(opt, g, opt_state,
                                         M.trainable(params)), 3)
    print(f"  \"dots\" step parts: forward + backward {fb:.1f} ms, AdamW "
          f"update {up:.1f} ms ({len(flat)} leaves)")
    del grads[:], g
    with window(profiler()) as prof:
        params, opt_state, m = step(params, opt_state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
    events, _ = device_summary(prof, "one step")
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=10))
    if trace:
        trace = Path(trace)
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))


def decode_one(tree: str) -> None:
    """Time the decode-attention kernel of checkout ``tree`` (run in a
    process of its own, so that its ``repro_torch`` is the one imported).
    Its bf16 error against the plain f32 result, in ulps, is reported
    beside the times and does not stop the run: a stripped-down copy of the
    kernel may be timed to see what a part of it costs."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import ops, ref

    ops.build(verbose=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {"tree": tree}
    for kind in ("serve", "full", "short"):
        sets = cs.decode_sets(kind)
        q, k, v, lens = sets[0]
        ulps = cs._bf16_ulps(ops.decode_attention(q, k, v, lens),
                             ref.decode_attention_ref(q.float(), k.float(),
                                                      v.float(), lens))
        row = cs.decode_timing(kind, sets)
        result[kind] = {key: row[key] for key in (
            "ms", "library_ms", "plain_ms", "bound_ms", "eager_ms", "mb")}
        result[kind]["ulps"] = ulps
        del sets
        torch.cuda.empty_cache()
    print("DECODE " + json.dumps(result))


def boot_one(tree: str) -> None:
    """Time both bootstrap kernels of checkout ``tree`` (in a process of its
    own) on chip_smoke's phase 2 and phase 3 sets.  Each kernel's equality
    with its plain version at one set is reported and does not stop the
    run: a stripped-down copy may be timed to see what a part costs."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import chip_smoke as cs
    from repro_torch.core import fused
    from repro_torch.data import make_lineitem
    from repro_torch.kernels.poisson_bootstrap import ops as pb, ref as pb_ref
    from repro_torch.kernels.segment_agg import ops as seg, ref as seg_ref

    pb.build(verbose=True)
    seg.build(verbose=True)
    result = {"tree": tree}
    data, _ = make_lineitem(scale_factor=10, group_by="shipinstruct",
                            device="cuda")
    buf, seeds, act, sets = cs.pb_sets(data)
    x, mask = buf[..., :sets[0][1]], sets[0][2]
    result["pb_exact"] = torch.equal(
        pb.bootstrap_moments_masked(x, mask, seeds, cs.B, lane_active=act),
        pb_ref.bootstrap_moments_masked_ref(x, mask, seeds, cs.B,
                                            lane_active=act))
    result["pb"] = cs.pb_graph_times(buf, seeds, act, sets)
    del data, buf, x
    torch.cuda.empty_cache()
    tax, _ = make_lineitem(scale_factor=10, group_by="tax", device="cuda")
    buf, seeds, rng = cs.seg_block(tax)
    seg_cap = fused.grouped_seg_cap(tax.offsets, N_CAP)
    streams = [(f"L={L}", cs.seg_random_stream(buf, seeds, rng, L)[0])
               for L in fused.seg_ladder(seg_cap, N_MAX)]
    streams.append(("phase 8 L=9000",
                    cs.seg_random_stream(buf, seeds, rng, 9000)[0]))
    streams += cs.seg_serve_sets(buf, seeds)
    args = streams[0][1]
    result["seg_exact"] = torch.equal(seg.segment_bootstrap_sorted(*args),
                                      seg_ref.segment_bootstrap_sorted_ref(
                                          *args))
    result["seg"] = {label: cs.seg_graph_ms(a) for label, a in streams}
    print("BOOT " + json.dumps(result))


def run_trees(trees, flag: str, tag: str):
    """Run this script with ``flag TREE`` for each tree in turn, each in a
    process of its own; the JSON each prints after ``tag``."""
    rows = []
    for tree in trees:
        print(f"== {tree}", flush=True)
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), flag, tree],
            capture_output=True, text=True, timeout=900)
        print(proc.stdout[-6000:], proc.stderr[-3000:], sep="\n")
        if proc.returncode != 0:
            fail(f"timing {tree} failed ({proc.returncode})")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith(tag)][-1]
        rows.append(json.loads(line[len(tag):]))
    return rows


def profile_boot(trees) -> None:
    """``boot_one`` for each tree in turn; a summary table at the end."""
    rows = run_trees(trees, "--boot-tree", "BOOT ")
    print("kernel | set | " + " | ".join(r["tree"] for r in rows)
          + "  (graph ms a call)")
    for kernel in ("pb", "seg"):
        print(f"{kernel} | bit-exact vs plain | "
              + " | ".join(str(r[f"{kernel}_exact"]) for r in rows))
        for label in rows[0][kernel]:
            print(f"{kernel} | {label} | " + " | ".join(
                f"{r[kernel][label]:.5f}" for r in rows))


def profile_decode(trees) -> None:
    """``decode_one`` for each tree in turn; a summary table at the end."""
    rows = run_trees(trees, "--decode-tree", "DECODE ")
    print("tree | kind | kernel ms | library ms | bound ms | kernel/bound | "
          "bf16 ulps vs plain f32 (> 1: wrong)")
    for r in rows:
        for kind in ("serve", "full", "short"):
            x = r[kind]
            print(f"{r['tree']} | {kind} | {x['ms']:.5f} | "
                  f"{x['library_ms']:.5f} | {x['bound_ms']:.5f} | "
                  f"{x['ms'] / x['bound_ms']:.2f} | {x['ulps']:.2f}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sharded", action="store_true",
                    help="profile the solo serve on a 4-shard session")
    ap.add_argument("--host", action="store_true",
                    help="profile the host serve (phase 14's requests)")
    ap.add_argument("--warm", action="store_true",
                    help="profile the warm waves (phase 16(a)'s repeats)")
    ap.add_argument("--lm", action="store_true",
                    help="profile the LM serve (Qwen2-1.5B bf16, 8 slots)")
    ap.add_argument("--train", action="store_true",
                    help="profile the training step (Qwen2-1.5B bf16)")
    ap.add_argument("--decode", nargs="*", metavar="TREE",
                    help="time the decode-attention kernel of each checkout "
                         "(default: this one)")
    ap.add_argument("--decode-tree", help=argparse.SUPPRESS)
    ap.add_argument("--boot", nargs="*", metavar="TREE",
                    help="time the two bootstrap kernels of each checkout "
                         "(default: this one)")
    ap.add_argument("--boot-tree", help=argparse.SUPPRESS)
    ap.add_argument("--spans", nargs=2, metavar=("WORKLOAD", "SEED"),
                    help="a traced run of a benchmark cell by launching "
                         "span")
    ap.add_argument("trace", nargs="?", help="write the Chrome trace here "
                    "(with --spans: the table, as JSON)")
    args = ap.parse_args()
    if not (args.sharded or args.host or args.warm or args.lm or args.train
            or args.decode is not None or args.boot is not None
            or args.decode_tree or args.boot_tree or args.spans):
        ap.error("name a mode; the pool's solo and grouped serves are the "
                 "benchmark's cells (aqpbench/run.py --trace 1)")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: a CUDA card is required")
    if args.decode_tree:
        decode_one(args.decode_tree)
        return
    if args.boot_tree:
        boot_one(args.boot_tree)
        return
    print(nvidia_smi("name,power.limit"))
    if args.spans:
        profile_spans(args.spans[0], int(args.spans[1]), args.trace)
        return
    if args.decode is not None:
        profile_decode(args.decode or [str(ROOT)])
        return
    if args.boot is not None:
        profile_boot(args.boot or [str(ROOT)])
        return
    if args.lm:
        profile_lm(args.trace)
        return
    if args.train:
        profile_train(args.trace)
        return
    from repro_torch.data import make_lineitem

    data, _ = make_lineitem(scale_factor=10, group_by="shipinstruct",
                            device="cuda")
    if args.host:
        once, reqs = host_once, host_requests(data)
    else:
        once = serve_once
        reqs = [r + (False,) for r in serve_requests(data)[0]]
    prof = profiler()
    print("warm-up run")
    if args.warm:
        warm_once(data, reqs, contextlib.nullcontext())
        print("profiled run")
        warm_once(data, reqs, window(prof))
    else:
        once(data, reqs)
        print("profiled run")
        with window(prof):
            once(data, reqs)
    events, tr = device_summary(prof, "serve")
    busy = tr.busy_s()
    for name, tag in (("Poisson bootstrap", "pb_"),
                      ("segment bootstrap", "seg_boot"),
                      ("segment aggregate", "seg_agg")):
        k_n, k_s = tr.kernel(tag)
        print(f"  {name}: {k_n} device kernels, {k_s * 1e3:.3f} ms = "
              f"{k_s / max(busy, 1e-12):.4f} of device time")
    print(events.table(sort_by="self_device_time_total", row_limit=12))
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    if args.trace:
        trace = Path(args.trace)
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))


if __name__ == "__main__":
    main()
