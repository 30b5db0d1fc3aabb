"""Arithmetic shared by the per-layer readers of ``metrics/``."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .roofline import work


def idle_share(run) -> Optional[float]:
    tr = run.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    busy = tr.busy_s()
    return 100.0 * (1.0 - busy / tr.window_s) if busy > 0 else None


def roofline(run, kernel: str, names: Sequence[str]) -> Optional[float]:
    """Sum over the traced calls of the least time, over the device time of
    the kernels named ``names``; None without calls or without device time,
    or when the profiler saw another number of launches than were made."""
    tr, tracer = run.get("trace"), run["tracer"]
    if tr is None or not tracer.calls[kernel]:
        return None
    launches, seconds = tr.kernel(names[0])
    if launches != tracer.launches.get(kernel) or seconds <= 0:
        return None
    _, seconds = tr.kernel(*names)
    calls = tracer.calls[kernel]
    live = torch.stack([c[-1] for c in calls]).cpu().tolist()
    least = 0.0
    for c, rows in zip(calls, live):
        if kernel == "poisson_bootstrap":
            groups, width, B, gate, _ = c
            if groups == 0 or width == 0:
                continue
            f, b = work.poisson_bootstrap(groups, width, B, int(rows), gate)
        else:
            length, lanes, B, _ = c
            if length == 0 or lanes == 0:
                continue
            f, b = work.segment_boot(length, lanes, B, int(rows))
        least += work.least_seconds(f, b)
    return 100.0 * least / seconds
