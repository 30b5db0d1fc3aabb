"""``BENCHMARK.json`` against the benchmark's contract, and the files it
names found by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["command"]) <= 32
    assert all(LINE.match(w) for w in M["command"])
    assert all(re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
               and not p.startswith("/") for p in M["paths"])


def test_check_fits_the_day_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in M[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for e in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in SOURCES
    for e in M["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in M["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert LINE.match(e["layer"])
        if e["name"].endswith("_roofline"):
            assert e["unit"] == "%"


def test_cells_and_metrics_are_consistent():
    cfgs = {c["name"]: c for c in M["configs"]}
    e2e = {e["name"]: e for e in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    pairs = set()
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert LINE.match(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        reported = [n for n, e in e2e.items()
                    if w["name"] in e.get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2
        layer = [e for e in M["per_layer"]
                 if w["name"] in e.get("workloads", [w["name"]])]
        assert layer and all(e["moves"] in reported for e in layer)
    used = {w["config"] for w in M["workloads"]}
    assert used == set(cfgs)


@pytest.mark.parametrize("c", M["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith(tuple(p + "/" for p in M["paths"]))
    body = json.loads((ROOT / c["file"]).read_text())
    assert body["reduced"] == c["reduced"] and body["name"] == c["name"]
    assert LINE.match(c["source"]) and len(c["reduced"]) <= 16


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(w):
    from aqpbench.cell import load_cell, reader
    cell = load_cell(w["name"])
    assert cell.mix["loop"] in ("open", "closed")
    exact = set(cell.kind.EXACT_LIMITS)
    assert all(name in cell.limits and cell.limits[name] == 0
               for name in exact)
    assert set(cell.limits) - exact <= set(cell.kind.READ_LIMITS)
    assert len(cell.limits) > len(exact)
    for m in cell.per_layer:
        assert callable(reader(m["name"]))


@pytest.mark.parametrize("c", M["configs"], ids=lambda c: c["name"])
def test_config_kind_fills_every_role(c):
    from aqpbench.cell import DEFAULT_KIND, ROLES, load_kind
    body = json.loads((ROOT / c["file"]).read_text())
    kind = load_kind(body.get("kind", DEFAULT_KIND))
    for role, names in ROLES.items():
        for name in names:
            assert hasattr(kind, name), (role, name)
    for name in ("make_data", "make_session", "make_traffic", "counters",
                 "describe", "layer_spans", "answer", "judge"):
        assert callable(getattr(kind, name)), name
    for name in ("send", "pump", "idle_round"):
        assert callable(getattr(kind.Client, name, None)), name
    assert not set(kind.EXACT_LIMITS) & set(kind.READ_LIMITS)
    from aqpbench import devtrace, kernels
    from aqpbench.cell import span_prefixes
    from aqpbench.roofline import work
    prefixes = span_prefixes(kind)
    assert isinstance(prefixes, tuple) and prefixes
    assert all(devtrace.PREFIX.match(p) for p in prefixes), prefixes
    # Each kernel entry has its four parts: a call site and its recorder,
    # a launch counter, its device-op names, and a work function frozen
    # under roofline/ with the peak that bounds it.
    for name, k in kernels.of(kind).items():
        assert NAME.match(name) and isinstance(k, kernels.Kernel), name
        assert callable(k.site) and callable(k.record), name
        assert callable(k.launches), name
        assert k.events and all(isinstance(e, str) and e
                                for e in k.events), name
        assert callable(k.work) and k.work.__module__.startswith(
            "aqpbench.roofline."), name
        assert k.peak in work.PEAKS and k.peak.endswith("_flops_per_s")


def test_tpch_kind_limits_are_the_judges():
    from aqpbench.cell import load_kind
    kind = load_kind("tpch_lineitem")
    assert set(kind.EXACT_LIMITS) == {"unanswered", "overclaimed"}
    assert set(kind.READ_LIMITS) == {"miss_share", "far_share"}


def test_tpch_kind_prefixes_are_the_default_spans():
    """The TPC-H kind's prefixes read the spans ``devtrace.SPANS`` has
    always named, and its kernels are rows 1 and 2 alone."""
    from aqpbench import devtrace, kernels
    from aqpbench.cell import load_kind, span_prefixes
    kind = load_kind("tpch_lineitem")
    assert kind.SPAN_PREFIXES == ("session.", "lane_pool.")
    assert span_prefixes(kind) == devtrace.DEFAULT_PREFIXES
    assert (devtrace.BENCH,) + span_prefixes(kind) == devtrace.SPANS \
        == ("aqpbench.", "session.", "lane_pool.")
    assert list(kernels.of(kind)) == ["poisson_bootstrap", "segment_boot"]
    assert kernels.of(kind)["segment_boot"].events == ("seg_boot_kernel",
                                                       "seg_plan_kernel")
