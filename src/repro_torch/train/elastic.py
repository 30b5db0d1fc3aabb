"""Elastic scaling + failure handling runbook, as code (the reference's
``train/elastic.py``, plain Python).

  1. ``plan_mesh``: pick a new (pod, data, model) factorization for any
     surviving device count, preferring to shrink the data axis first
     (model parallel degree is tied to weight shard shapes; keeping it
     stable makes restore cheap).
  2. mesh-independent checkpoints (train/checkpoint.py): restore places
     each leaf on the target device.
  3. deterministic data skip-ahead: the pipeline is stateless in (step,
     global_batch), so a restarted job resumes at the right sample
     without replay (data/pipeline.py).
  4. straggler mitigation: ``StepWatchdog`` flags steps that miss their
     deadline.  On the card a step is launched asynchronously, so the
     caller stops the watchdog after a synchronising read of the step's
     result (the loss ``.item()``); stopping it after the launch alone
     would time the enqueue.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_mesh(n_devices: int, *, model_parallel: int = 16,
              pods: int = 1) -> MeshPlan:
    """Factorize surviving devices into (pod, data, model).

    Keeps the model axis at the requested degree whenever it divides the
    device count (weight shards stay the same shape across restarts);
    otherwise falls back to the largest power-of-two divisor.
    """
    if n_devices % pods:
        pods = 1
    per_pod = n_devices // pods
    mp = model_parallel
    while mp > 1 and per_pod % mp:
        mp //= 2
    data = per_pod // mp
    if pods > 1:
        return MeshPlan((pods, data, mp), ("pod", "data", "model"))
    return MeshPlan((data, mp), ("data", "model"))


def degrade_ladder(n_start: int, *, model_parallel: int = 16,
                   pods: int = 1) -> Sequence[MeshPlan]:
    """The restart ladder: mesh plans for successive halvings -- what the
    launcher walks when capacity keeps shrinking."""
    plans = []
    n = n_start
    while n >= model_parallel:
        plans.append(plan_mesh(n, model_parallel=model_parallel,
                               pods=pods if n == n_start else 1))
        n //= 2
    return plans


class StepWatchdog:
    """Flags steps exceeding a deadline (straggler detection hook).

    Keeps an EMA of step time and counts the steps slower than ``factor``
    times it; ``last`` is the last step's seconds.
    """

    def __init__(self, factor: float = 3.0, ema: float = 0.9):
        self.factor = factor
        self.ema = ema
        self.avg: Optional[float] = None
        self.slow_steps = 0
        self.last: Optional[float] = None
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> bool:
        """Returns True if this step was a straggler."""
        dt = self.last = time.perf_counter() - self._t0
        slow = self.avg is not None and dt > self.factor * self.avg
        self.avg = dt if self.avg is None else (
            self.ema * self.avg + (1 - self.ema) * dt)
        if slow:
            self.slow_steps += 1
        return slow
