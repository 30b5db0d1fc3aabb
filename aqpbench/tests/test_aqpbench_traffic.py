"""The generator: every seed sends the same set of requests, in its own
order, and a closed loop's clients take turns at one queue."""
import collections
import itertools
import json
from pathlib import Path

import numpy as np
import pytest

from aqpbench.traffic.generator import Traffic

HERE = Path(__file__).resolve().parents[1]
CFG = {"scale_factor": 0.01, "rows_per_sf": 6_000_000,
       "parts_per_sf": 200_000, "groups": 9}
SIZES = np.full(9, 6_666, np.int64)


def mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def first(m, seed, k, stream=0):
    spec = itertools.islice(Traffic(m, CFG, SIZES, seed).stream(stream), k)
    return [(s["kind"], s["func"], round(s["epsilon"], 6)) for s in spec]


@pytest.mark.parametrize("name", ["solo_open", "solo_closed",
                                  "groupby_closed"])
def test_same_set_in_another_order(name):
    m = mix(name)
    k = len(m["cycle"] if "cycle" in m else m["kinds"]) * 4 * m["levels"]
    a, b = first(m, 2**31 + 41, k), first(m, 2**33 + 7, k)
    assert a != b and collections.Counter(a) == collections.Counter(b)
    assert first(m, 2**31 + 41, k) == a
    assert first(m, 2**31 + 41, k, stream=20_000) != a


def test_kinds_follow_the_cycle_and_levels_span_the_range():
    m = mix("groupby_closed")
    got = first(m, 5, 96)
    assert [g[0] for g in got[:6]] == m["cycle"] * 2
    avg = sorted({e for kind, f, e in got if kind == "group" and f == "avg"})
    assert len(avg) == m["levels"]
    lo, hi = m["kinds"]["group"]["funcs"]["avg"]
    ratio = np.asarray(avg) / avg[0]
    np.testing.assert_allclose(ratio[-1], (hi - (hi - lo) / 16)
                               / (lo + (hi - lo) / 16), rtol=1e-4)


def test_open_loop_window_offers_a_fixed_count():
    m = mix("solo_open")
    t = Traffic(m, CFG, SIZES, 2**31 + 9)
    plan = t.arrivals(51.0)
    assert len(plan) == round(m["rate_per_s"] * 51.0)
    due = [d for d, _ in plan]
    assert due == sorted(due) and 0 <= due[0] and due[-1] < 51.0
