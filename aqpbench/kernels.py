"""The program's kernels that a traced sub-window records, one entry each:

* where the program calls it (``site``, resolved when the sub-window
  starts) and the recorder that wraps that call while the sub-window is
  traced, appending each call's shapes and its live count (a 0-d integer
  tensor on the device, so recording never syncs);
* its launch counter, read at the sub-window's two ends;
* the device-op names that pick it out in the trace: the first is launched
  once a counted launch, the others are helpers whose time is its time too;
* its work function under ``roofline/`` (one record, the live count read
  to an int, to ``(flops, bytes)``) and the key of ``roofline/peaks.json``
  that bounds its arithmetic.

Rows 1 and 2 are every kind's (:data:`SHARED`); a kind adds its own in a
``KERNELS`` dict of the same entries.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Tuple

import torch

from .roofline import work


@dataclasses.dataclass(frozen=True)
class Kernel:
    site: Callable[[], Tuple[object, str]]      # () -> (owner, attribute)
    record: Callable[[Callable, list], Callable]  # (call, records) -> call
    launches: Callable[[], int]
    events: Tuple[str, ...]
    work: Callable[[tuple], Tuple[float, float]]
    peak: str = "fp32_flops_per_s"


def _pb_ops():
    from repro_torch.kernels.poisson_bootstrap import ops
    return ops


def _seg_ops():
    from repro_torch.kernels.segment_agg import ops
    return ops


def _record_pb(pb, calls: list):
    def rec_pb(x, mask, seeds, B, *, lane_active=None):
        live = mask != 0
        gate = 0
        if lane_active is not None:
            live = live & lane_active.bool()[..., None]
            gate = 1 if lane_active.dtype == torch.bool else 4
        groups = x.numel() // max(x.shape[-1], 1)
        calls.append((groups, x.shape[-1], int(B), gate, live.sum()))
        return pb(x, mask, seeds, B, lane_active=lane_active)
    return rec_pb


def _record_seg(seg, calls: list):
    def rec_seg(x, mask, slot, seed, lane_off, B, n_slots):
        calls.append((x.shape[0], lane_off.shape[0] - 1, int(B),
                      (mask > 0).sum()))
        return seg(x, mask, slot, seed, lane_off, B, n_slots)
    return rec_seg


SHARED: Dict[str, Kernel] = {
    # Row 1: csrc/poisson_bootstrap.cu.
    "poisson_bootstrap": Kernel(
        site=lambda: (_pb_ops(), "bootstrap_moments_masked"),
        record=_record_pb,
        launches=lambda: _pb_ops().counter.launches,
        events=("pb_kernel",),
        work=work.poisson_bootstrap_record),
    # Row 2: csrc/segment_agg.cu.
    "segment_boot": Kernel(
        site=lambda: (_seg_ops(), "segment_bootstrap_sorted"),
        record=_record_seg,
        launches=lambda: _seg_ops().boot_counter.launches,
        events=("seg_boot_kernel", "seg_plan_kernel"),
        work=work.segment_boot_record),
}


def of(kind) -> Dict[str, Kernel]:
    """The shared entries and the kind's own."""
    return {**SHARED, **getattr(kind, "KERNELS", {})}


@contextlib.contextmanager
def recording(kernels: Dict[str, Kernel], calls: Dict[str, List[tuple]]):
    """Wrap each kernel's call site with its recorder for the block,
    appending to ``calls[name]``."""
    saved = []
    try:
        for name, k in kernels.items():
            owner, attr = k.site()
            fn = getattr(owner, attr)
            setattr(owner, attr, k.record(fn, calls[name]))
            saved.append((owner, attr, fn))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)
