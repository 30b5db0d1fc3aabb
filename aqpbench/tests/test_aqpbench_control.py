"""The control (the plain reference in the program's place at twice the
bound) comes out not correct at a test size, on three seeds, and the plain
reference's sound twin (at the stated bound) comes out correct."""
import numpy as np
import pytest
import torch

from aqpbench.control import control_run, specs
from aqpbench.data import lineitem
from aqpbench.reference import control, exact, judge
from aqpbench.traffic.generator import Traffic

SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


@pytest.fixture
def cell(test_cell):
    test_cell.config["scale_factor"] = 0.05
    test_cell.config["session"]["B"] = 200
    test_cell.mix["kinds"]["solo"]["funcs"] = {
        "avg": [0.01, 0.025], "sum": [0.01, 0.025], "std": [0.01, 0.025]}
    test_cell.limits = {"miss_share": 0.15, "unanswered": 0}
    return test_cell


@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(cell, seed):
    out = control_run(cell, seed, 60, torch.device("cpu"))
    assert not out["correct"], out
    assert out["verdict"]["miss_share"] > cell.limits["miss_share"]


def test_stated_bound_is_correct(cell):
    seed = SEEDS[0]
    cfg = cell.config
    values, offsets = lineitem.make_table(cfg, seed, "cpu")
    reqs = specs(Traffic(cell.mix, cfg, np.diff(offsets), seed), 60)
    gen = torch.Generator().manual_seed(5)
    answers = [control.control_answer(values, offsets, r, gen, B=200,
                                      n_min=200, n_cap=1 << 16, widen=1.0)
               for r in reqs]
    ex = exact.exact_answers(cfg, seed, "cpu", {r["func"] for r in reqs})
    v = judge.judge(list(zip(reqs, answers)), ex)
    assert v["miss_share"] <= cell.limits["miss_share"], v
