"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell of one chip can have.  The run skips the look
for a card and runs on the CPU at a test size; the fault is planted when
the measured window starts, so the warm-up is sound."""
import time

import numpy as np
import pytest

from aqpbench import harness


def plant(monkeypatch, fault):
    from repro_torch.serve import lane_pool, session

    def step_unchanged(values, offsets, state, *a, **k):
        return state

    harvest = lane_pool.LanePool._harvest

    def drop_half(self):
        before = set(self.results)
        out = harvest(self)
        for i, qid in enumerate(sorted(set(self.results) - before)):
            if i % 2 == 0:
                del self.results[qid]
        return out

    complete = session.AQPSession._complete

    def altered(self, entry, *, theta, **kw):
        return complete(self, entry, theta=np.asarray(theta) * 1.1, **kw)

    if fault == "step_returns_state_unchanged":
        monkeypatch.setattr(lane_pool, "fused_step", step_unchanged)
    elif fault == "half_the_answers_left_out":
        monkeypatch.setattr(lane_pool.LanePool, "_harvest", drop_half)
    elif fault == "answer_altered_where_produced":
        monkeypatch.setattr(session.AQPSession, "_complete", altered)


def run(cell, monkeypatch, fault, grace_s=5.0):
    drive = harness.drive

    def window_with_fault(client, traffic, mix, *, first_stream, **kw):
        if first_stream == 0 and fault is not None:
            plant(monkeypatch, fault)
        return drive(client, traffic, mix, first_stream=first_stream, **kw)

    monkeypatch.setattr(harness, "drive", window_with_fault)
    return harness.run_cell(cell, 2**31 + 77, 3.0, False, "cpu",
                            time.perf_counter(), grace_s=grace_s)


def test_sound_run_is_correct(test_cell, monkeypatch):
    out = run(test_cell, monkeypatch, None, grace_s=harness.GRACE_S)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0


@pytest.mark.parametrize("fault", ["step_returns_state_unchanged",
                                   "half_the_answers_left_out",
                                   "answer_altered_where_produced"])
def test_fault_is_not_correct(test_cell, monkeypatch, fault):
    out = run(test_cell, monkeypatch, fault)
    assert not out["correct"], (fault, out["checks"])
