"""Work of the bootstrap kernels from the shapes of each call, frozen here
so that a change to the program cannot move the yardstick.  A kernel's
entry (``aqpbench/kernels.py``) names its work function, which takes one
recorded call (its shapes, then its live count) and returns ``(flops,
bytes)``, and the key of ``peaks.json`` that bounds its arithmetic.

A call's bootstrap needs one Poisson weight and one multiply-add per moment
for every (live row, replicate) pair: ``2 * moments + 1`` operations a pair.
Its bytes are each input read once and each output written once.  Neither
depends on how a kernel implements the call, so no correct implementation
reads above 100 % of its roofline.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

F32, I32, I64 = 4, 4, 8


def pair_flops(pairs: int, moments: int) -> float:
    return float(pairs) * (2 * moments + 1)


def poisson_bootstrap(groups: int, width: int, B: int, live_rows: int,
                      gate_bytes: int = 0, moments: int = 5
                      ) -> Tuple[float, float]:
    """``(flops, bytes)`` of one ``bootstrap_moments_masked`` call over
    ``groups`` rows of ``width`` slots (values and mask f32, one int64 seed
    a group, an optional gate) writing ``(groups, B, moments)`` f32."""
    nbytes = (groups * width * (F32 + F32) + groups * (I64 + gate_bytes)
              + groups * B * moments * F32)
    return pair_flops(live_rows * B, moments), float(nbytes)


def segment_boot(length: int, lanes: int, B: int, live_rows: int,
                 moments: int = 3) -> Tuple[float, float]:
    """``(flops, bytes)`` of one ``segment_bootstrap_sorted`` call over a
    packed stream of ``length`` elements (value and mask f32, slot int32,
    seed int64) in ``lanes`` lanes (offsets int64) writing ``(lanes, B,
    moments)`` f32."""
    nbytes = (length * (F32 + F32 + I32 + I64) + (lanes + 1) * I64
              + lanes * B * moments * F32)
    return pair_flops(live_rows * B, moments), float(nbytes)


def poisson_bootstrap_record(record: tuple) -> Tuple[float, float]:
    """A recorded call ``(groups, width, B, gate_bytes, live_rows)``; one
    over no slot launches nothing."""
    groups, width, B, gate, live = record
    if groups == 0 or width == 0:
        return 0.0, 0.0
    return poisson_bootstrap(groups, width, B, live, gate)


def segment_boot_record(record: tuple) -> Tuple[float, float]:
    """A recorded call ``(length, lanes, B, live_rows)``; one over an empty
    stream launches nothing."""
    length, lanes, B, live = record
    if length == 0 or lanes == 0:
        return 0.0, 0.0
    return segment_boot(length, lanes, B, live)


def least_seconds(flops: float, nbytes: float,
                  peak: str = "fp32_flops_per_s") -> float:
    """The least time the card could take: the larger of the arithmetic at
    the published rate ``peak`` and the byte term at the published HBM
    rate."""
    return max(flops / PEAKS[peak], nbytes / PEAKS["hbm_bytes_per_s"])
