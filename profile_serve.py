#!/usr/bin/env python3
"""Where a serve run's time goes on the card.

Runs ``chip_smoke.py``'s serve phase (TPC-H lineitem SF10 resident on the
card, 16 avg/sum/var/std requests through a forced-POOL ``AQPSession`` with
the reference defaults) once to warm up, then once more under
``torch.profiler``, and prints the wall time, the device busy share (summed
CUDA kernel time over wall time), and the top device and host ops.

Run from the root of a checkout on a machine with a CUDA card:
``python3 profile_serve.py [TRACE.json]``; with a path, the Chrome trace is
written there.
"""
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import SERVE, fail, nvidia_smi, serve_requests  # noqa: E402


def serve_once(data, reqs) -> float:
    from repro_torch.aqp.query import Query, Request
    from repro_torch.serve import AQPSession, Planner, Route

    sess = AQPSession(data, planner=Planner(mode=Route.POOL, pool_lanes=8),
                      **SERVE)
    t0 = time.perf_counter()
    for f, e in reqs:
        sess.submit(Request(query=Query(func=f, epsilon=e)))
    res = sess.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(res) != len(reqs) or not all(r.success for r in res):
        fail("a profiled request failed")
    st = sess.stats()
    print(f"  wall {wall * 1e3:.1f} ms, pool ticks {st['pool']['ticks']}, "
          f"dispatches {st['fused_dispatches']}")
    return wall


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: a CUDA card is required")
    from repro_torch.data import make_lineitem

    print(nvidia_smi("name,power.limit"))
    data, _ = make_lineitem(scale_factor=10, group_by="shipinstruct",
                            device="cuda")
    reqs, _ = serve_requests(data)
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
    if len(sys.argv) > 1:
        trace = Path(sys.argv[1])
        trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace))


if __name__ == "__main__":
    main()
