"""The device trace of a traced window, read from ``torch.profiler``'s
kineto events (nothing is written to disk).

* device intervals: every operation that ran on the card (kernels, copies,
  sets), by name;
* host spans: ``record_function`` spans whose names start with the
  benchmark's prefix or one of the program's (the cell's kind names them;
  :data:`DEFAULT_PREFIXES` where it names none);
* the window: the ``aqpbench.window`` span.

A span's device-side copy (the profiler's ``gpu_user_annotation``, which
covers the kernels the span launched) is no operation, so it is dropped by
the same prefixes; a span of the program under a prefix the cell does not
name would count as device work.

``busy_s`` is the union of the device intervals inside the window, so
overlapping operations count once.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

WINDOW = "aqpbench.window"
BENCH = "aqpbench."                             # the benchmark's own spans
DEFAULT_PREFIXES = ("session.", "lane_pool.")   # the program's, by default
SPANS = (BENCH,) + DEFAULT_PREFIXES
# A program's prefix: lower case and ending in a dot, so none can take in
# the card's own operations (``void ...``, ``Memcpy ...``).
PREFIX = re.compile(r"^[a-z][a-z0-9_]*\.$")


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


@dataclasses.dataclass
class DeviceTrace:
    names: List[str]            # device op names
    start: np.ndarray           # (k,) ns
    end: np.ndarray             # (k,) ns
    spans: List[Tuple[str, int, int]]   # host spans (name, start, end) ns
    window: Tuple[int, int]     # ns

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> np.ndarray:
        """(k, 2) merged device-busy intervals clipped to the window, ns."""
        lo, hi = self.window
        s = np.clip(self.start, lo, hi)
        e = np.clip(self.end, lo, hi)
        keep = e > s
        s, e = s[keep], e[keep]
        if s.size == 0:
            return np.zeros((0, 2), np.int64)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        run_end = np.maximum.accumulate(e)
        new = np.ones(s.shape, bool)
        new[1:] = s[1:] > run_end[:-1]
        starts = s[new]
        idx = np.flatnonzero(new)
        ends = np.maximum.reduceat(e, idx)
        return np.stack([starts, ends], 1)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) * 1e-9

    def kernel(self, *needles: str) -> Tuple[int, float]:
        """(count, device seconds) of the operations whose name holds one of
        ``needles``, over the whole trace."""
        n, t = 0, 0
        for name, s, e in zip(self.names, self.start, self.end):
            if any(k in name for k in needles):
                n += 1
                t += int(e - s)
        return n, t * 1e-9

    def count_in_window(self) -> int:
        lo, hi = self.window
        return int(np.sum((self.start >= lo) & (self.start < hi)))

    def top_ops(self, k: int = 10) -> List[list]:
        tot: Dict[str, int] = defaultdict(int)
        for name, s, e in zip(self.names, self.start, self.end):
            tot[name[:80]] += int(e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[name, t * 1e-9] for name, t in top]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """Idle device seconds in the window by the innermost host span
        running at each gap's midpoint, largest first."""
        iv = self.busy_intervals()
        lo, hi = self.window
        edges = np.concatenate([[lo], iv.ravel(), [hi]]).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        if gaps.size == 0:
            return []
        mids = (gaps[:, 0] + gaps[:, 1]) // 2
        label = np.full(mids.shape, "host:outside spans", dtype=object)
        width = np.full(mids.shape, np.iinfo(np.int64).max, np.int64)
        for name, s, e in self.spans:
            if name == WINDOW:
                continue
            a, b = np.searchsorted(mids, [s, e])
            if a == b:
                continue
            sel = slice(a, b)
            inner = width[sel] > (e - s)
            label[sel] = np.where(inner, name, label[sel])
            width[sel] = np.where(inner, e - s, width[sel])
        tot: Dict[str, int] = defaultdict(int)
        for name, (a, b) in zip(label, gaps):
            tot[name] += int(b - a)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[name, t * 1e-9] for name, t in top]


def read(prof, prefixes: Tuple[str, ...] = DEFAULT_PREFIXES
         ) -> Optional[DeviceTrace]:
    """The trace of a stopped ``torch.profiler.profile``, with the program's
    spans named by ``prefixes`` (the benchmark's always); None without a
    window span."""
    spans_of = (BENCH,) + tuple(prefixes)
    cuda = torch.autograd.DeviceType.CUDA
    names, starts, ends, spans = [], [], [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = _ns(e, "start")
        d = _ns(e, "duration")
        if e.device_type() == cuda:
            # The device side of a ``record_function`` span is no operation.
            if d > 0 and not name.startswith(spans_of):
                names.append(name)
                starts.append(s)
                ends.append(s + d)
        elif name == WINDOW:
            window = (s, s + d)
        elif name.startswith(spans_of):
            spans.append((name, s, s + d))
    if window is None:
        return None
    return DeviceTrace(names, np.asarray(starts, np.int64),
                       np.asarray(ends, np.int64), spans, window)
