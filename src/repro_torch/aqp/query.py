"""Approximate analytical queries (paper Listing 1):

    SELECT X, f(Y) FROM D GROUP BY X [WHERE P]
    ERROR WITHIN eps CONFIDENCE 1-delta [METRIC m]

The fields and validation of the reference's ``Query`` and ``Request``.  The
predicate AST and the cache signature come with the warm-cache and host
slices; a predicate is carried as given and such queries route to the host
engine, which the port does not have yet.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Optional

METRICS = ("l2", "linf", "l1", "lp", "order", "diff")


@dataclasses.dataclass(frozen=True)
class Query:
    func: str                              # estimator name (core.estimators)
    epsilon: Optional[float] = None        # absolute bound
    epsilon_rel: Optional[float] = None    # relative bound (vs pilot |theta|)
    delta: float = 0.05
    metric: str = "l2"
    predicate: Optional[Any] = None        # row predicate: callable | AST
    lp: Optional[float] = None             # the p of metric="lp" (p >= 1)
    group_by: bool = False                 # one answer PER GROUP

    def __post_init__(self):
        if self.metric not in METRICS:
            raise ValueError(f"metric {self.metric!r} not in {METRICS}")
        if self.metric == "lp":
            if self.lp is None or self.lp < 1:
                raise ValueError(
                    f"metric='lp' requires lp >= 1; got {self.lp!r}")
        elif self.lp is not None:
            raise ValueError(
                f"lp={self.lp!r} only applies to metric='lp' "
                f"(got metric {self.metric!r})")
        if self.metric != "order" and (self.epsilon is None) == (
                self.epsilon_rel is None):
            raise ValueError("exactly one of epsilon / epsilon_rel required")


_RID = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: a Listing-1 query plus its SLO envelope.

    ``deadline_s`` is the latency budget in seconds from submission (used
    for admission order and reported as ``slo_met``), ``priority`` breaks
    ties first (higher first), ``tenant`` names the traffic class, ``rid`` is
    a process-unique id assigned at construction.
    """
    query: Query
    deadline_s: Optional[float] = None
    priority: int = 0
    tenant: str = ""
    rid: int = dataclasses.field(default_factory=lambda: next(_RID))

    def __post_init__(self):
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(
                f"deadline_s must be positive; got {self.deadline_s!r}")
