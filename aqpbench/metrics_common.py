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


def roofline(run, kernel: str,
             names: Optional[Sequence[str]] = None) -> Optional[float]:
    """Sum over the traced calls of ``kernel`` of the least time its entry's
    work function and peak give, over the device time of the kernels named
    ``names`` (the entry's device-op names where None); None without calls
    or without device time, or when the profiler saw another number of
    launches of the first name than were made."""
    tr, tracer = run.get("trace"), run["tracer"]
    if tr is None or not tracer.calls.get(kernel):
        return None
    entry = tracer.kernels[kernel]
    names = names or entry.events
    launches, seconds = tr.kernel(names[0])
    if launches != tracer.launches.get(kernel) or seconds <= 0:
        return None
    _, seconds = tr.kernel(*names)
    calls = tracer.calls[kernel]
    live = torch.stack([c[-1] for c in calls]).cpu().tolist()
    least = 0.0
    for c, n in zip(calls, live):
        least += work.least_seconds(*entry.work(c[:-1] + (int(n),)),
                                    peak=entry.peak)
    return 100.0 * least / seconds
