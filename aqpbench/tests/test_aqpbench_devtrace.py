"""``devtrace.read`` on a stand-in profiler: a span of the program is known
by the prefixes the cell's kind names, both as a host span and by its
device-side copy, which is no device operation.  With the default prefixes
a span under another prefix reads as today: its copy counts as device
work."""
from types import SimpleNamespace

import pytest
import torch

from aqpbench import devtrace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
US = 1000


class Event:
    def __init__(self, name, device, start_us, end_us):
        self._name, self._device = name, device
        self._start, self._dur = start_us * US, (end_us - start_us) * US

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur


def profiler(events):
    results = SimpleNamespace(events=lambda: list(events))
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def toy_events(span="toy.step"):
    """A host span and its device-side copy over 0-100 us, two kernels
    inside it (10-30 and 60-70 us), the window over 0-200 us."""
    return [Event(devtrace.WINDOW, CPU, 0, 200),
            Event(devtrace.WINDOW, CUDA, 0, 200),
            Event(span, CPU, 0, 100),
            Event(span, CUDA, 0, 100),
            Event("void toy_kernel_a", CUDA, 10, 30),
            Event("void toy_kernel_b", CUDA, 60, 70)]


@pytest.mark.parametrize("prefixes", [("toy.",), ("session.", "toy.")])
def test_kind_prefix_drops_the_device_copy(prefixes):
    tr = devtrace.read(profiler(toy_events()), prefixes)
    assert tr.busy_s() == pytest.approx(30e-6)
    assert tr.count_in_window() == 2
    assert "toy.step" not in [name for name, _ in tr.top_ops()]
    assert ("toy.step", 0, 100 * US) in tr.spans
    assert tr.window == (0, 200 * US)


def test_default_prefixes_count_the_copy_as_work():
    for tr in (devtrace.read(profiler(toy_events())),
               devtrace.read(profiler(toy_events()),
                             devtrace.DEFAULT_PREFIXES)):
        assert tr.busy_s() == pytest.approx(100e-6)
        assert tr.count_in_window() == 3
        assert tr.top_ops()[0] == ["toy.step", pytest.approx(100e-6)]
        assert tr.spans == []


def test_program_spans_read_as_before_without_prefixes():
    events = toy_events("session.admit") + [
        Event("lane_pool.tick", CPU, 100, 180),
        Event("lane_pool.tick", CUDA, 100, 180),
        Event("aqpbench.pump", CPU, 90, 190),
        Event("void pb_kernel", CUDA, 120, 150)]
    tr = devtrace.read(profiler(events))
    assert devtrace.SPANS == ("aqpbench.", "session.", "lane_pool.")
    assert tr.names == ["void toy_kernel_a", "void toy_kernel_b",
                        "void pb_kernel"]
    assert tr.busy_s() == pytest.approx(60e-6)
    assert tr.count_in_window() == 3
    assert tr.spans == [("session.admit", 0, 100 * US),
                        ("lane_pool.tick", 100 * US, 180 * US),
                        ("aqpbench.pump", 90 * US, 190 * US)]
    named = devtrace.read(profiler(events), ("session.", "lane_pool."))
    assert (named.names, named.spans, named.window) \
        == (tr.names, tr.spans, tr.window)
    assert devtrace.read(profiler(events[2:])) is None


@pytest.mark.parametrize("prefix", ["toy.", "miss_eval.", "lm2."])
def test_prefix_pattern_takes_program_names(prefix):
    assert devtrace.PREFIX.match(prefix)


@pytest.mark.parametrize("prefix", ["", "toy", "void", "Memcpy", "v",
                                    "void ", "Toy.", "9a.", "toy.step.x",
                                    "a-b."])
def test_prefix_pattern_refuses_broad_names(prefix):
    assert not devtrace.PREFIX.match(prefix)
