#!/usr/bin/env python3
"""Where a serve run's time goes on the card.

Runs one of ``chip_smoke.py``'s serve phases once to warm up, then once
more under ``torch.profiler``, and prints the wall time, the device busy
share (summed CUDA kernel time over wall time), and the top device and host
ops.  The phases (TPC-H lineitem SF10 resident on the card, a forced-POOL
``AQPSession`` with the reference defaults):

* default: the solo serve, 16 avg/sum/var/std requests, GROUP BY
  SHIPINSTRUCT;
* ``--grouped``: the grouped serve, 8 GROUP BY requests as lane blocks and
  4 solo requests in one pool, GROUP BY TAX;
* ``--sharded``: the solo serve through a sharded session
  (``data_shards=4, mesh=False``), ``chip_smoke.py`` phase 18's pool;
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

The solo and grouped profiles print each bootstrap kernel's share of the
device time.  Run from the root of a checkout on a machine with a CUDA
card: ``python3 profile_serve.py [--grouped | --sharded | --host | --warm |
--lm | --train | --decode [TREE ...] | --boot [TREE ...]] [TRACE.json]``;
with a path,
the Chrome trace is written there.
"""
import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (LM_ARCH, LM_S_MAX, LM_SLOTS, N_CAP,  # noqa: E402
                        N_MAX, SERVE, TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ,
                        fail, grouped_requests, host_requests, lm_requests,
                        nvidia_smi, run_lm_serve, serve_requests)


def serve_once(data, reqs, data_shards: int = 1) -> float:
    from repro_torch.aqp.query import Query, Request
    from repro_torch.serve import AQPSession, Planner, Route

    sess = AQPSession(data, data_shards=data_shards,
                      mesh=False if data_shards > 1 else None,
                      planner=Planner(mode=Route.POOL, pool_lanes=8,
                                      data_shards=data_shards), **SERVE)
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
    return wall


def host_once(data, reqs) -> float:
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
    return wall


def warm_once(data, reqs, measured) -> float:
    """Phase 16(a)'s solo waves: the requests cold, then, inside
    ``measured`` (a context manager), their exact repeats and their near
    repeats at epsilon / 1.1; returns the measured waves' wall time."""
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
    return wall


def device_summary(prof, wall: float, what: str):
    """Device busy time over ``wall`` and the kernel count of a profile."""
    events = prof.key_averages()
    cuda = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in cuda)
    n_kernels = sum(e.count for e in cuda)
    print(f"  {what}: device busy {dev_us / 1e3:.2f} ms of {wall * 1e3:.1f} "
          f"ms wall: busy share {dev_us / 1e6 / wall:.3f}, idle share "
          f"{1 - dev_us / 1e6 / wall:.3f}; {n_kernels} device kernels")
    return events, cuda, dev_us, n_kernels


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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        st = run_lm_serve(cfg, params, prompts)
    steps = st["steps"]
    print(f"  {len(st['done'])} requests, {steps} decode steps, "
          f"{len(st['splice_s'])} prefills, wall {st['wall'] * 1e3:.1f} ms")
    events, cuda, dev_us, _ = device_summary(prof, st["wall"], "serve")
    da_us = sum(e.self_device_time_total for e in cuda
                if "decode_attn" in e.key)
    da_n = sum(e.count for e in cuda if "decode_attn" in e.key)
    calls = cfg.n_layers * steps
    print(f"  decode attention: {calls} calls ran {da_n} device kernels, "
          f"{da_us / 1e3:.3f} ms = {da_us / max(dev_us, 1e-9):.4f} of device "
          f"time ({da_us / max(calls, 1):.2f} us a call)")
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            _, caches = M.decode_step(cfg, params, tok, caches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _, _, step_us, n_kernels = device_summary(prof, wall,
                                             f"{n} lone decode steps")
    print(f"  per decode step: {n_kernels / n:.0f} device kernels, device "
          f"busy {step_us / n / 1e3:.3f} ms, wall {wall / n * 1e3:.3f} ms")


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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events, cuda, dev_us, _ = device_summary(prof, wall, "one step")
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
    ap.add_argument("--grouped", action="store_true",
                    help="profile the grouped serve (GROUP BY TAX)")
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
    ap.add_argument("trace", nargs="?", help="write the Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: a CUDA card is required")
    if args.decode_tree:
        decode_one(args.decode_tree)
        return
    if args.boot_tree:
        boot_one(args.boot_tree)
        return
    print(nvidia_smi("name,power.limit"))
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

    data, _ = make_lineitem(scale_factor=10, group_by=(
        "tax" if args.grouped else "shipinstruct"), device="cuda")
    once = (host_once if args.host else
            (lambda d, r: serve_once(d, r, data_shards=4)) if args.sharded
            else serve_once)
    if args.host:
        reqs = host_requests(data)
    elif args.grouped:
        reqs = grouped_requests(data)[0]
    else:
        reqs = [r + (False,) for r in serve_requests(data)[0]]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    print("warm-up run")
    if args.warm:
        warm_once(data, reqs, contextlib.nullcontext())
        print("profiled run")
        wall = warm_once(data, reqs, prof)
    else:
        once(data, reqs)
        print("profiled run")
        with prof:
            wall = once(data, reqs)
    events, cuda, dev_us, _ = device_summary(prof, wall, "serve")
    for name, tag in (("Poisson bootstrap", "pb_"),
                      ("segment bootstrap", "seg_boot"),
                      ("segment aggregate", "seg_agg")):
        k_us = sum(e.self_device_time_total for e in cuda if tag in e.key)
        k_n = sum(e.count for e in cuda if tag in e.key)
        print(f"  {name}: {k_n} device kernels, {k_us / 1e3:.3f} ms = "
              f"{k_us / max(dev_us, 1e-9):.4f} of device time")
    print(events.table(sort_by="self_device_time_total", row_limit=12))
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    if args.trace:
        trace = Path(args.trace)
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))


if __name__ == "__main__":
    main()
