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
  4 solo requests in one pool, GROUP BY TAX.

Run from the root of a checkout on a machine with a CUDA card:
``python3 profile_serve.py [--grouped] [TRACE.json]``; with a path, the
Chrome trace is written there.
"""
import argparse
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import (SERVE, fail, grouped_requests,  # noqa: E402
                        nvidia_smi, serve_requests)


def serve_once(data, reqs) -> float:
    from repro_torch.aqp.query import Query, Request
    from repro_torch.serve import AQPSession, Planner, Route

    sess = AQPSession(data, planner=Planner(mode=Route.POOL, pool_lanes=8),
                      **SERVE)
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grouped", action="store_true",
                    help="profile the grouped serve (GROUP BY TAX)")
    ap.add_argument("trace", nargs="?", help="write the Chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: a CUDA card is required")
    from repro_torch.data import make_lineitem

    print(nvidia_smi("name,power.limit"))
    data, _ = make_lineitem(scale_factor=10, group_by=(
        "tax" if args.grouped else "shipinstruct"), device="cuda")
    if args.grouped:
        reqs = grouped_requests(data)[0]
    else:
        reqs = [r + (False,) for r in serve_requests(data)[0]]
    print("warm-up run")
    serve_once(data, reqs)
    print("profiled run")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        wall = serve_once(data, reqs)
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    n_kernels = sum(e.count for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"  device busy {dev_us / 1e3:.2f} ms of {wall * 1e3:.1f} ms wall: "
          f"busy share {dev_us / 1e6 / wall:.3f}, idle share "
          f"{1 - dev_us / 1e6 / wall:.3f}; {n_kernels} device kernels")
    print(events.table(sort_by="self_device_time_total", row_limit=12))
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    if args.trace:
        trace = Path(args.trace)
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))


if __name__ == "__main__":
    main()
