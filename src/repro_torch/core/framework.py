"""The MISS framework (paper Algorithm 1): a generic sample -> estimate ->
test -> predict loop with pluggable INITIALIZE / SAMPLE / ESTIMATE / PREDICT
subroutines.  ``core/l2miss.py`` instantiates it into the concrete L2Miss
algorithm (Algorithm 3); ``core/extensions.py`` wraps it for other metrics.
The loop itself is host Python; the subroutines put their work on the data's
device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Protocol, Tuple

import numpy as np

Vec = np.ndarray


class Subroutines(Protocol):
    """The four pluggable subroutines of Algorithm 1 (host-side signatures)."""

    def initialize(self) -> np.ndarray:            # (l, m) initial size rows
        ...

    def sample(self, n_vec: Vec, it: int):          # -> opaque sample handle
        ...

    # Optional: predicted rows a sample(n_vec) call will actually touch.
    # Incremental samplers (core/sampling.SampleStore) return the delta vs
    # already-resident rows; when absent the framework falls back to
    # sum(n_vec), i.e. fresh-resample accounting.
    # def sample_cost(self, n_vec: Vec) -> int: ...

    def estimate(self, sample, it: int) -> Tuple[float, np.ndarray]:
        ...                                          # -> (error e, theta_hat)

    def predict(self, profile_n: Vec, profile_e: Vec, it: int):
        ...                 # -> (n_next (m,), info dict) ; raises MissFailure


class MissFailure(RuntimeError):
    """Unrecoverable failure signalled by PREDICT (Algorithm 2 FAILURE)."""


@dataclasses.dataclass
class MissTrace:
    """Full record of one MISS run."""

    success: bool
    status: str                      # ok | unrecoverable | budget | max_iters
    n: np.ndarray                    # final per-group sample size
    theta: Optional[np.ndarray]      # final approximate result
    error: float                     # final estimated error
    iterations: int
    profile_n: np.ndarray            # (k, m)
    profile_e: np.ndarray            # (k,)
    total_sampled: int               # rows actually touched across the run:
                                     # delta-based when SAMPLE reuses nested
                                     # samples (sample_cost), else sum C(n)
    wall_time_s: float
    info: dict                       # last PREDICT info (beta, r2, status...)

    @property
    def total_sample_size(self) -> int:
        return int(np.sum(self.n))


def run_miss(
    subs: Subroutines,
    epsilon: float,
    *,
    max_iters: int = 64,
    budget_rows: Optional[int] = None,
    on_iteration: Optional[Callable[[int, Vec, float], None]] = None,
) -> MissTrace:
    """Algorithm 1.  Iterates until ESTIMATE(e) <= epsilon or failure."""
    t0 = time.perf_counter()
    init_rows = np.asarray(subs.initialize())
    l = init_rows.shape[0]
    profile_n: List[np.ndarray] = []
    profile_e: List[float] = []
    total_sampled = 0
    info: dict = {}
    n_vec = init_rows[0]
    theta = None
    err = float("inf")
    status = "max_iters"
    cost_fn = getattr(subs, "sample_cost", None)

    for it in range(max_iters):
        if it < l:
            n_vec = init_rows[it]
        else:
            try:
                n_vec, info = subs.predict(
                    np.stack(profile_n), np.asarray(profile_e), it
                )
            except MissFailure:
                status = "unrecoverable"
                break
        total_sampled += (
            int(cost_fn(n_vec)) if cost_fn is not None else int(np.sum(n_vec))
        )
        if budget_rows is not None and total_sampled > budget_rows:
            status = "budget"
            break
        s = subs.sample(n_vec, it)
        err, theta = subs.estimate(s, it)
        profile_n.append(np.asarray(n_vec))
        profile_e.append(float(err))
        if on_iteration is not None:
            on_iteration(it, n_vec, float(err))
        # Test: only accept in the prediction phase (the init rows are probes
        # by construction; accepting them is also correct and we do when the
        # constraint already holds -- mirrors Alg. 3 line 14 exactly).
        if err <= epsilon:
            status = "ok"
            break

    success = status == "ok"
    return MissTrace(
        success=success,
        status=status,
        n=np.asarray(n_vec),
        theta=None if theta is None else np.asarray(theta),
        error=float(err),
        iterations=len(profile_e),
        profile_n=np.stack(profile_n) if profile_n else np.zeros((0, len(n_vec))),
        profile_e=np.asarray(profile_e),
        total_sampled=total_sampled,
        wall_time_s=time.perf_counter() - t0,
        info=info,
    )
