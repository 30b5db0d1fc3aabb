"""A traced run: its window runs untraced and its host metrics read from it;
the profiler records only a sub-window driven after the window drained."""
import time

from aqpbench import harness


def test_traced_run_profiles_only_the_sub_window(test_cell, monkeypatch):
    monkeypatch.setattr(harness, "TRACE_SECONDS", 1.0)
    profiled = []
    record = harness.Tracer.record

    def spy(self, client, traffic, mix):
        profiled.append(len(client.records))
        return record(self, client, traffic, mix)

    monkeypatch.setattr(harness.Tracer, "record", spy)
    out = harness.run_cell(test_cell, 2**31 + 78, 2.0, True, "cpu",
                           time.perf_counter())
    assert out["correct"], out["checks"]
    # The profiler started only after every request of the window was sent.
    assert len(profiled) == 1 and 0 < profiled[0] < out["attempted"]
    assert "open.answer_p95_ms" in out["metrics"]
    assert 0.9 <= out["device"]["window_s"] <= 10.0
