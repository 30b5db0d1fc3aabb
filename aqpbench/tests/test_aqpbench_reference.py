"""The reference's exact answers against a direct float64 computation, and
the comparison's counts on hand-made answers."""
import numpy as np
import pytest

from aqpbench.data import lineitem
from aqpbench.reference import exact, judge

CFG = {"scale_factor": 0.005, "rows_per_sf": 6_000_000,
       "parts_per_sf": 200_000, "groups": 9}
FUNCS = ["avg", "sum", "var", "std"]


def direct(x: np.ndarray, func: str) -> float:
    x = x.astype(np.float64)
    return {"avg": x.mean(), "sum": x.sum(), "var": x.var(),
            "std": x.std()}[func]


def test_exact_answers_match_direct_float64():
    seed = 2**31 + 17
    vals, off = lineitem.make_table(CFG, seed, "cpu")
    x = vals.numpy()
    got = exact.exact_answers(CFG, seed, "cpu", FUNCS)
    for f in FUNCS:
        want = [direct(x[off[g]:off[g + 1]], f) for g in range(9)]
        np.testing.assert_allclose(got[f], want, rtol=1e-12, atol=1e-9)


def test_judge_counts_units_and_failures():
    ex = {"avg": np.asarray([10.0, 20.0])}
    solo = {"func": "avg", "epsilon": 1.0}
    grp = {"func": "avg", "epsilon": 1.0, "group_by": True}
    recs = [(solo, {"theta": [10.5, 20.5], "success": True}),   # 0.71: hit
            (solo, {"theta": [11.0, 21.0], "success": True}),   # 1.41: miss
            (grp, {"theta": [10.5, 22.5], "success": False}),   # 2.5: far
            (solo, None)]
    v = judge.judge(recs, ex)
    assert (v["units"], v["misses"], v["unanswered"], v["unsuccessful"]) \
        == (4, 2, 1, 1)
    assert v["far_share"] == pytest.approx(1 / 4)
    assert v["overclaimed"] == 0 and v["beyond_reported"] is None
    table = judge.checks(v, {"miss_share": 0.4, "unanswered": 0})
    assert not judge.passed(table)


def test_judge_reads_the_reported_error():
    ex = {"avg": np.asarray([10.0, 20.0])}
    solo = {"func": "avg", "epsilon": 1.0}
    grp = {"func": "avg", "epsilon": 1.0, "group_by": True}
    recs = [
        # deviation 0.71 within a reported 0.8: sound
        (solo, {"theta": [10.5, 20.5], "success": True, "error": 0.8}),
        # deviation 0.71 beyond a reported 0.5: beyond, not overclaimed
        (solo, {"theta": [10.5, 20.5], "success": True, "error": 0.5}),
        # reports its bound met at an error of 1.2: overclaimed
        (solo, {"theta": [10.1, 20.1], "success": True, "error": 1.2}),
        # a group reports failure at 1.5 (truthful), another met at 0.9
        (grp, {"theta": [10.2, 21.0], "success": False, "error": 1.5,
               "group_error": [0.9, 1.5], "group_success": [True, False]}),
    ]
    v = judge.judge(recs, ex)
    assert v["units"] == 5 and v["overclaimed"] == 1
    assert v["beyond_reported"] == pytest.approx(1 / 5)
    assert not judge.passed(judge.checks(v, {"overclaimed": 0}))
    # float32 rounding of a bound met exactly is no overclaim
    edge = [(solo, {"theta": [10.0, 20.0], "success": True,
                    "error": float(np.float32(1.0 + 3e-8))})]
    assert judge.judge(edge, ex)["overclaimed"] == 0
