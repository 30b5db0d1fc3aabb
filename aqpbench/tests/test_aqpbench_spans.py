"""The readers of the program's own spans and counters: host reads, idle
time inside the fused tick's phases, ticks and iterations per answer.  On
a hand-built trace, on one with only the benchmark's spans (as a program
without spans of its own leaves), and in a traced CPU run of the test
cell reporting ``sf100_tax.solo_closed``'s metrics."""
import dataclasses
import enum
import time
from types import SimpleNamespace

import numpy as np
import pytest

from aqpbench import harness
from aqpbench.cell import load_cell, reader
from aqpbench.devtrace import DeviceTrace

NEW = ("lane_pool.host_reads_per_answer", "device.idle_in_step_share",
       "lane_pool.ticks_per_answer", "lane_pool.iterations_per_answer")


def _trace(spans):
    # Busy [100, 200) and [600, 700) of a 1000 ns window: idle gaps
    # [0, 100), [200, 600), [700, 1000).
    return DeviceTrace(["k1", "k2"], np.asarray([100, 600], np.int64),
                       np.asarray([200, 700], np.int64), spans, (0, 1000))


PROGRAM = [("lane_pool.tick", 0, 1000), ("lane_pool.tick", 0, 1000),
           ("lane_pool.tier_step", 0, 500),
           ("lane_pool.step.fit_predict", 0, 90),
           ("lane_pool.step.read", 90, 150),
           ("lane_pool.step.estimate", 200, 500),
           ("lane_pool.harvest", 700, 1000),
           ("lane_pool.harvest.read", 750, 800),
           ("lane_pool.harvest.read", 1200, 1300)]   # after the window


def _run(spans, answers=4):
    tracer = SimpleNamespace(span=(10.0, 20.0))
    traced = [{"t_done": 10.0 + i} for i in range(answers)]
    traced.append({"t_done": 25.0})              # polled after the window
    return {"trace": _trace(spans), "tracer": tracer, "traced": traced}


def test_host_reads_count_read_spans_in_the_window():
    assert reader(NEW[0])(_run(PROGRAM)) == 2 / 4
    assert reader(NEW[0])(_run(PROGRAM, answers=0)) is None


def test_idle_in_step_share_takes_the_phase_labels():
    # [0, 100) lies in fit_predict, [200, 600) in estimate, [700, 1000) in
    # the harvest: 500 of 1000 ns.
    assert reader(NEW[1])(_run(PROGRAM)) == pytest.approx(50.0)


def test_benchmark_spans_alone_read_nothing():
    """Only the benchmark's own spans, as around a program without any:
    both span readers return None and do not raise."""
    bench = [("lane_pool.tick", 0, 1000), ("lane_pool.harvest", 700, 1000),
             ("session.admit", 100, 200)]
    assert reader(NEW[0])(_run(bench)) is None
    assert reader(NEW[1])(_run(bench)) is None
    assert reader(NEW[0])({"trace": None, "tracer": None}) is None
    assert reader(NEW[1])({"trace": None}) is None


class _Route(enum.Enum):
    POOL = "pool"
    WARM = "warm"
    HOST = "host"


@dataclasses.dataclass
class _Resp:
    route: _Route
    ticks: int
    iterations: int


@dataclasses.dataclass
class _OldResp:
    route: _Route


def test_counters_average_pool_and_warm_answers():
    answered = [{"resp": _Resp(_Route.POOL, 10, 8)},
                {"resp": _Resp(_Route.WARM, 2, 1)},
                {"resp": _Resp(_Route.HOST, 0, 30)}]
    assert reader(NEW[2])({"answered": answered}) == 6.0
    assert reader(NEW[3])({"answered": answered}) == 4.5
    old = [{"resp": _OldResp(_Route.POOL)}]
    for name in NEW[2:]:
        assert reader(name)({"answered": old}) is None
        assert reader(name)({"answered": []}) is None


def test_traced_cpu_run_reads_the_program_metrics(test_cell, monkeypatch):
    per_layer = load_cell("sf100_tax.solo_closed").per_layer
    assert {m["name"] for m in per_layer} >= set(NEW)
    test_cell.per_layer = per_layer
    monkeypatch.setattr(harness, "TRACE_SECONDS", 4.0)
    out = harness.run_cell(test_cell, 2**31 + 91, 2.0, True, "cpu",
                           time.perf_counter())
    assert out["correct"], out["checks"]
    m = out["metrics"]
    for name in ("lane_pool.host_reads_per_answer",
                 "lane_pool.ticks_per_answer",
                 "lane_pool.iterations_per_answer"):
        assert m[name]["value"] > 0, name
    assert m["lane_pool.ticks_per_answer"]["value"] \
        >= m["lane_pool.iterations_per_answer"]["value"] >= 1
