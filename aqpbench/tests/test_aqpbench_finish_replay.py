"""The reader of ``lane_pool.finish_replay_share``: on hand-built traces, on
one with the program's phases but no replay (0 where the program has the
finish graph path and ran nothing from it, nothing where it has none, as
the program before that path), and as a metric ``BENCHMARK.json`` gives
cells 2 and 4."""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from aqpbench.cell import load_cell, reader
from aqpbench.devtrace import DeviceTrace

NAME = "lane_pool.finish_replay_share"


def _run(spans):
    return {"trace": DeviceTrace(["k"], np.asarray([0], np.int64),
                                 np.asarray([10], np.int64), spans,
                                 (100, 1000)),
            "tracer": SimpleNamespace(span=(0.0, 1.0))}


# Three tier ticks and a block tick in the window: the first tier tick's
# TEST runs eagerly (and captures), the other three replay.  A TEST outside
# any step (a one-shot call), one before the window, and the pre-read
# phase's own replays are not counted.
SPANS = [("lane_pool.tier_step", 100, 300),
         ("lane_pool.step.fit_predict", 110, 150),
         ("lane_pool.step.replay", 120, 140),
         ("lane_pool.step.test", 160, 190),
         ("lane_pool.step.finish_capture", 170, 180),
         ("lane_pool.step.fit_predict", 200, 220),
         ("lane_pool.step.replay", 205, 215),
         ("lane_pool.step.test", 230, 260),
         ("lane_pool.step.finish_replay", 240, 250),
         ("lane_pool.tier_step", 300, 400),
         ("lane_pool.step.test", 310, 340),
         ("lane_pool.step.finish_replay", 320, 330),
         ("lane_pool.block_step", 400, 500),
         ("lane_pool.step.test", 410, 440),
         ("lane_pool.step.finish_replay", 420, 430),
         ("session.loop", 600, 700),
         ("lane_pool.step.test", 610, 640),
         ("lane_pool.tier_step", 0, 90),
         ("lane_pool.step.test", 10, 50),
         ("lane_pool.step.finish_replay", 20, 30)]


def test_share_of_step_phases_that_replay():
    assert reader(NAME)(_run(SPANS)) == pytest.approx(75.0)


EAGER = [sp for sp in SPANS if sp[0] not in (
    "lane_pool.step.finish_replay", "lane_pool.step.finish_capture")]


def test_finish_path_that_replays_nothing_reads_zero():
    assert reader(NAME)(_run(EAGER)) == 0.0
    assert reader(NAME)(_run([])) is None
    assert reader(NAME)({"trace": None}) is None


def test_pre_read_replays_alone_read_zero():
    """A tick whose pre-read phase replays and whose TEST does not."""
    spans = [sp for sp in EAGER if sp[0] != "lane_pool.step.replay"] + [
        ("lane_pool.step.replay", 165, 175)]
    assert reader(NAME)(_run(spans)) == 0.0


def test_program_without_the_finish_path_reads_nothing(monkeypatch):
    """A program whose graph module has the pre-read cache alone (the
    program before the finish graphs) reads None, replays or not."""
    import_module = importlib.import_module
    monkeypatch.setattr(
        importlib, "import_module",
        lambda name, *a: SimpleNamespace(PreReadGraphs=object)
        if name == "repro_torch.core.graphs" else import_module(name, *a))
    assert reader(NAME)(_run(EAGER)) is None
    assert reader(NAME)(_run(SPANS)) is None


def test_reported_in_the_closed_loop_cells():
    for cell in ("sf100_tax.groupby_closed", "sf100_tax.solo_closed"):
        m = {e["name"]: e for e in load_cell(cell).per_layer}[NAME]
        assert m["moves"] == "answer_p95_ms" and m["unit"] == "%"
        assert m["layer"] == "lane pool and fused step"
        assert m["source"] == "program_span" and m["better"] == "higher"
    assert NAME not in {e["name"] for e in
                        load_cell("sf10_shipinstruct.solo_open").per_layer}
