"""The comparison that decides ``correct``.

Every request sent in a run is judged against the exact answer of its query
(``exact.py``) by what its answer says: the estimate lies within the
request's bound, with probability at least 1 - delta (paper Listing 1).

* A solo request is one unit: it misses when ``||theta_hat - theta||_2``
  exceeds its bound.
* A GROUP BY request is one unit per group: group g misses when
  ``|theta_hat_g - theta_g|`` exceeds the bound.

The numbers, of which each cell compares those its ``checks/<workload>.json``
limits: ``miss_share`` (units beyond their bound, over units),
``far_share`` (units beyond twice their bound, over units), ``unanswered``
(requests with no answer a minute after the window closed) and
``overclaimed`` (units whose answer reports its bound met with a reported
error above the bound).  An answer that reports its bound not met (MISS's
unrecoverable-failure verdict) says so truthfully: it counts as
``unsuccessful`` and among the run's failures, and its estimate is judged
like any other.  ``beyond_reported`` (units whose deviation exceeds the
error the answer reports) is read out beside them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

FAR = 2.0       # ``far_share`` counts units beyond FAR x their bound
ROUNDING = 1e-6  # the program holds bounds and errors in float32


def judge(records: List[Tuple[dict, Optional[dict]]],
          exact: Dict[str, np.ndarray],
          log: Optional[Callable[[str], None]] = None) -> Dict[str, float]:
    """``records``: ``(spec, answer)`` per request, the answer ``{"theta":
    (groups,), "success": bool}`` with, from the program, ``"error"`` (and
    ``"group_error"``, ``"group_success"`` for GROUP BY), or None.  ``log``
    hears of the first few answers that missed or failed."""
    units = misses = far = unanswered = unsuccessful = 0
    overclaimed = beyond = reported = 0
    worst = 0.0
    told = 0
    for spec, ans in records:
        if ans is None:
            unanswered += 1
            continue
        unsuccessful += not bool(ans["success"])
        missed0 = misses
        theta = exact[spec["func"]]
        eps = float(spec["epsilon"])
        d = np.ravel(np.asarray(ans["theta"], np.float64)) - theta
        if spec.get("group_by"):
            dev = np.abs(d)
            err, ok = ans.get("group_error"), ans.get("group_success")
        else:
            dev = np.asarray([np.sqrt(np.sum(d * d))])
            err, ok = ans.get("error"), ans.get("success")
        units += dev.shape[0]
        misses += int(np.sum(dev > eps))
        far += int(np.sum(dev > FAR * eps))
        worst = max(worst, float(dev.max()) / eps)
        if err is not None:
            err = np.ravel(np.asarray(err, np.float64))
            ok = np.ravel(np.asarray(ok, bool))
            reported += dev.shape[0]
            beyond += int(np.sum(dev > err))
            overclaimed += int(np.sum(ok & (err > eps * (1 + ROUNDING))))
        if log is not None and told < 10 and (
                misses > missed0 or not ans["success"]):
            told += 1
            log(f"answer missed or failed: {spec} success={ans['success']} "
                f"theta={np.ravel(ans['theta']).tolist()} "
                f"exact={theta.tolist()} bound={eps:.6g}")
    return {"units": units, "misses": misses,
            "miss_share": misses / max(units, 1),
            "far_share": far / max(units, 1),
            "unanswered": unanswered, "unsuccessful": unsuccessful,
            "overclaimed": overclaimed,
            "beyond_reported": beyond / reported if reported else None,
            "worst_over_bound": worst}


def checks(result: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, dict]:
    """``{name: {"value", "limit"}}`` for each number the cell's limits
    name."""
    return {name: {"value": result[name], "limit": limit}
            for name, limit in limits.items()}


def passed(table: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in table.values())
