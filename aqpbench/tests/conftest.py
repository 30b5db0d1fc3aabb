"""Shared fixtures of the benchmark's CPU tests: a test-size cell whose
every piece is the benchmark's own, cut only in scale."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Test size: 60 000 rows in 4 groups, a smaller bootstrap, bounds wide
# enough that every request converges well inside the groups.
TEST_SESSION = dict(B=100, n_min=200, n_max=400, n_cap=8192, max_iters=16)
TEST_MIX = {"loop": "closed", "clients": 2, "levels": 4,
            "warmup_requests": 2, "kinds": {"solo": {
                "funcs": {"avg": [0.05, 0.08], "sum": [0.05, 0.08],
                          "std": [0.05, 0.08]}, "bound": "norm"}}}


@pytest.fixture
def test_cell():
    from aqpbench.cell import load_cell
    cell = load_cell("sf10_shipinstruct.solo_open")
    cell.config = copy.deepcopy(cell.config)
    cell.config["scale_factor"] = 0.01
    cell.config["session"].update(TEST_SESSION)
    cell.mix = copy.deepcopy(TEST_MIX)
    # A few answers a test window: one chance miss must not fail it.
    cell.limits = {"miss_share": 0.5, "unanswered": 0}
    return cell
