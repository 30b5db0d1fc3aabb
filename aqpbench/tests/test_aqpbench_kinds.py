"""Kinds of configuration.  What the TPC-H kind reads, pinned to the values
the harness read before configurations named their kind: the same table
from the seed, the same requests in the same order on every stream, the
same session seed.  And a kind added by files alone, outside the checkout,
with its own span prefix and kernel, run through the harness on the CPU
(and traced on a card)."""
import dataclasses
import hashlib
import itertools
import json
import math
import time

import pytest
import torch

from aqpbench import devtrace, harness
from aqpbench.cell import HERE, load_cell, load_kind

SEEDS = [2**31 + 11, 2**33 + 5]
MIXES = ["solo_open", "solo_closed", "groupby_closed"]
STREAMS = [0, 10_000, 20_000]      # the window's, the warm-up's, the traced

# At scale factor 0.01: group sizes, the float64 sum of the table, the
# session's seed, and a digest of the first 64 requests (and an open loop's
# first 64 due times) of each mix on each stream.
PINNED = {
    ("tpch_sf10_shipinstruct", SEEDS[0]): (
        [15191, 14931, 14899, 14979], 2141070164.0126953, 1997512639,
        {"solo_open": ["c09b636a5b8bfd21", "10939dd40c62f5f8",
                       "11840384ebb58def"],
         "solo_closed": ["d49520ffae6cdc03", "7115a234ed6cbef9",
                         "743f30ec8a2b340b"],
         "groupby_closed": ["0a103d04afec6951", "0dfe7a5c14570694",
                            "170db8cbb91f3380"]}),
    ("tpch_sf10_shipinstruct", SEEDS[1]): (
        [14903, 15077, 14953, 15067], 2147907639.7095337, 1073748835,
        {"solo_open": ["fc8ab1a212d87bca", "98ba15c01bea1966",
                       "1d8e1ebbb845130f"],
         "solo_closed": ["16bfe7fef3bd470a", "2e923667d86e80ea",
                         "be881e1788a43c8c"],
         "groupby_closed": ["a8d780562ef59977", "04c0830b15bc7ce7",
                            "2f1e1465ab0ba68f"]}),
    ("tpch_sf100_tax", SEEDS[0]): (
        [6803, 6645, 6616, 6620, 6702, 6702, 6602, 6638, 6672],
        2144240847.3981323, 1997512639,
        {"solo_open": ["83b3b443ffe74e63", "4b9b5ebb445e8963",
                       "f036727a4fa91c68"],
         "solo_closed": ["24218d74589e8ac1", "df6c84193fa783cc",
                         "d623b96530ce12da"],
         "groupby_closed": ["0d17d6181cdb30ae", "4600820a09b8fe90",
                            "b0d1d5bad4b73cb4"]}),
    ("tpch_sf100_tax", SEEDS[1]): (
        [6596, 6709, 6621, 6717, 6617, 6742, 6816, 6588, 6594],
        2143210959.5482788, 1073748835,
        {"solo_open": ["3d665bb18a7f1ee9", "88b38de11af949bf",
                       "85fae0d9c0a37609"],
         "solo_closed": ["358c79f83f987d2f", "9b0ca0d71ae608b4",
                         "851404b479c98d8a"],
         "groupby_closed": ["d368a68fee7f519e", "f97e6fffee4ca995",
                            "2e3e4315e643f2b3"]}),
}


CELL_OF = {"tpch_sf10_shipinstruct": "sf10_shipinstruct.solo_open",
           "tpch_sf100_tax": "sf100_tax.solo_closed"}


def cell(name, mix_name="solo_open"):
    """A cell of configuration ``name`` at scale factor 0.01 with the mix
    ``mix_name``."""
    c = load_cell(CELL_OF[name])
    assert "kind" not in c.config and c.kind.__name__.endswith(
        "tpch_lineitem")
    config = dict(c.config, scale_factor=0.01)
    mix = json.loads((HERE / "traffic" / f"{mix_name}.json").read_text())
    return dataclasses.replace(c, config=config, mix=mix)


def digest(specs, dues):
    def g(x):
        return float(f"{x:.10g}")
    rows = [[s["kind"], s["func"], s["group_by"], g(s["delta"]),
             g(s["epsilon"])] for s in specs]
    body = json.dumps({"specs": rows, "due": [g(d) for d in dues]})
    return hashlib.sha256(body.encode()).hexdigest()[:16]


@pytest.mark.parametrize("key", sorted(PINNED), ids=lambda k: f"{k[0]}-{k[1]}")
def test_table_and_session_seed(key):
    name, seed = key
    sizes, total, session_seed, _ = PINNED[key]
    c = cell(name)
    data = c.kind.make_data(c, seed, "cpu")
    assert data.sizes.tolist() == sizes
    assert math.fsum(data.values.double().ravel().tolist()) == total
    sess = c.kind.make_session(c, data, seed)
    assert sess.seed == session_seed
    s = c.config["session"]
    assert (sess.B, sess.n_min, sess.n_max, sess.max_iters, sess.n_cap) \
        == (s["B"], s["n_min"], s["n_max"], s["max_iters"], s["n_cap"])


@pytest.mark.parametrize("m", MIXES)
@pytest.mark.parametrize("key", sorted(PINNED), ids=lambda k: f"{k[0]}-{k[1]}")
def test_requests_on_every_stream(key, m):
    name, seed = key
    digests = PINNED[key][3]
    c = cell(name, m)
    data = c.kind.make_data(c, seed, "cpu")
    traffic = c.kind.make_traffic(c, data, seed)
    got = []
    for stream in STREAMS:
        specs = list(itertools.islice(traffic.stream(stream), 64))
        dues = ([d for d, _ in traffic.arrivals(51.0, stream=stream)[:64]]
                if c.mix["loop"] == "open" else [])
        got.append(digest(specs, dues))
    assert got == digests[m]


# A kind added by files alone: sums of slices of a vector on the device,
# served by a server that answers every queued request each round, inside
# spans of its own prefix, through a "kernel" (a plain torch op behind a
# call site and a launch counter) registered with its work.
TOY_KIND = '''
import contextlib
import time
from types import SimpleNamespace

import numpy as np
import torch
from torch.profiler import record_function

from aqpbench.kernels import Kernel

EXACT_LIMITS = ("unanswered",)
READ_LIMITS = ("wrong_share",)
SPAN_PREFIXES = ("toy.",)


def _slice_sum(x):
    ops.launches += 1
    return x.sum()


ops = SimpleNamespace(slice_sum=_slice_sum, launches=0)


def _record(fn, calls):
    def rec(x):
        calls.append((x.numel(), (x != 0).sum()))
        return fn(x)
    return rec


def _work(record):
    n, live = record
    return float(live), float(8 * n)


KERNELS = {"toy": Kernel(site=lambda: (ops, "slice_sum"), record=_record,
                         launches=lambda: ops.launches,
                         events=("reduce_kernel",), work=_work)}


def make_data(cell, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    return torch.randint(0, 1000, (cell.config["rows"],), generator=gen,
                         device=device, dtype=torch.int64)


class Server:
    def __init__(self, data):
        self.data, self.queue, self.done = data, [], {}
        self.rows_touched = self.completed = 0

    def answer(self, lo, hi):
        with record_function("toy.answer"):
            return int(ops.slice_sum(self.data[lo:hi]))

    def round(self):
        time.sleep(0.001)
        with record_function("toy.round"):
            for rid, lo, hi in self.queue:
                self.done[rid] = self.answer(lo, hi)
                self.rows_touched += hi - lo
                self.completed += 1
        self.queue = []


def make_session(cell, data, seed):
    return Server(data)


class Traffic:
    def __init__(self, mix, cfg, seed):
        self.mix, self.cfg, self.seed = mix, cfg, seed

    def stream(self, first):
        rng = np.random.default_rng([self.seed, first])
        width = self.cfg["width"]
        while True:
            lo = int(rng.integers(0, self.cfg["rows"] - width))
            yield {"lo": lo, "hi": lo + width}

    def arrivals(self, seconds, stream=0, limit=None):
        rate = float(self.mix["rate_per_s"])
        n = int(round(rate * seconds)) if np.isfinite(seconds) else limit
        due = np.arange(n) / rate
        return list(zip(due.tolist(), self.stream(stream)))


def make_traffic(cell, data, seed):
    return Traffic(cell.mix, cell.config, seed)


class Client:
    def __init__(self, server, device):
        self.server, self.device = server, device
        self.records, self.outstanding, self.pump_s = [], {}, []

    def send(self, spec, t_sent):
        rid = len(self.records)
        self.server.queue.append((rid, spec["lo"], spec["hi"]))
        rec = {"spec": spec, "t_sent": t_sent, "t_done": None, "resp": None}
        self.outstanding[rid] = rec
        self.records.append(rec)
        return rec

    def pump(self):
        t0 = time.perf_counter()
        self.server.round()
        t1 = time.perf_counter()
        self.pump_s.append(t1 - t0)
        done = []
        for rid in [r for r in self.outstanding if r in self.server.done]:
            rec = self.outstanding.pop(rid)
            rec["t_done"], rec["resp"] = t1, self.server.done.pop(rid)
            done.append(rec)
        return done

    def idle_round(self):
        self.server.round()


def counters(server):
    return {"rows_touched": server.rows_touched, "completed": server.completed}


def describe(server):
    return f"toy server: {server.completed} answered"


@contextlib.contextmanager
def layer_spans():
    yield


def answer(resp):
    return resp


def judge(cell, seed, device, pending, log):
    x = make_data(cell, seed, device).cpu().numpy()
    unanswered = sum(a is None for _, a in pending)
    wrong = sum(a is None or a != int(x[s["lo"]:s["hi"]].sum())
                for s, a in pending)
    verdict = {"wrong_share": wrong / max(len(pending), 1),
               "unanswered": unanswered}
    table = {n: {"value": verdict[n], "limit": v}
             for n, v in cell.limits.items()}
    ok = all(c["value"] <= c["limit"] for c in table.values())
    return {"correct": ok and bool(pending), "failed": unanswered,
            "verdict": verdict, "checks": table}
'''


def write_toy(tmp_path, kind=TOY_KIND):
    """The toy kind, a configuration naming it, a mix, a checks file and a
    copy of the manifest with the toy cell, all under ``tmp_path``; returns
    the folder that stands for ``aqpbench/``."""
    bench = tmp_path / "aqpbench"
    files = {
        "kinds/toy_sums.py": kind,
        "configs/toy_sums.json": json.dumps(
            {"name": "toy_sums", "kind": "toy_sums", "rows": 20_000,
             "width": 500, "reduced": []}),
        "traffic/toy_closed.json": json.dumps(
            {"loop": "closed", "clients": 2, "warmup_requests": 4}),
        "checks/toy_sums.closed.json": json.dumps(
            {"wrong_share": 0, "unanswered": 0}),
    }
    for rel, body in files.items():
        (bench / rel).parent.mkdir(parents=True, exist_ok=True)
        (bench / rel).write_text(body)
    manifest = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    manifest["configs"].append(
        {"name": "toy_sums", "source": "a toy", "reduced": [],
         "file": "aqpbench/configs/toy_sums.json", "why": "a toy"})
    manifest["workloads"].append(
        {"name": "toy_sums.closed", "config": "toy_sums",
         "traffic": "toy_closed", "chips": 1, "why": "a toy"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return bench


@pytest.fixture
def toy_cell(tmp_path):
    return load_cell("toy_sums.closed", root=tmp_path,
                     here=write_toy(tmp_path))


def checkout_files():
    return sorted(p.relative_to(HERE) for p in HERE.rglob("*")
                  if "__pycache__" not in p.parts)


@pytest.mark.parametrize("fault", [False, True])
def test_kind_added_by_files_alone(toy_cell, monkeypatch, fault):
    before = checkout_files()
    if fault:
        monkeypatch.setattr(toy_cell.kind.Server, "answer",
                            lambda self, lo, hi: int(self.data[lo:hi].sum())
                            + (lo % 2))
    out = harness.run_cell(toy_cell, 2**31 + 5, 2.0, False, "cpu",
                           time.perf_counter(), grace_s=5.0)
    assert set(out) == {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert set(out["metrics"]) == {"rows_per_answer", "setup_s"}
    assert out["metrics"]["rows_per_answer"]["value"] == 500
    assert out["attempted"] > 100 and out["failed"] == 0
    assert out["device"]["platform"] == "cpu"
    assert out["correct"] is (not fault), out["checks"]
    assert checkout_files() == before


@pytest.mark.parametrize("device", ["cpu",
                                    pytest.param("cuda", marks=pytest.mark.cuda)])
def test_kind_names_its_spans_and_kernels(toy_cell, monkeypatch, device):
    """Traced, the toy's ``toy.`` spans are host spans and their device
    copies no device work; its kernel's calls are recorded once a launch."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    before = checkout_files()
    ops, seen = toy_cell.kind.ops, {}
    record, read = harness.Tracer.record, devtrace.read

    def spy_record(self, client, traffic, mix):
        seen["tracer"], launched = self, ops.launches
        record(self, client, traffic, mix)
        seen["launched"] = ops.launches - launched

    def spy_read(prof, *prefixes):
        seen["default"] = read(prof)
        seen["trace"] = read(prof, *prefixes)
        return seen["trace"]

    monkeypatch.setattr(harness.Tracer, "record", spy_record)
    monkeypatch.setattr(devtrace, "read", spy_read)
    monkeypatch.setattr(harness, "TRACE_SECONDS", 1.0)
    out = harness.run_cell(toy_cell, 2**31 + 9, 2.0, True, device,
                           time.perf_counter(), grace_s=5.0)
    tracer, tr, default = seen["tracer"], seen["trace"], seen["default"]
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert tracer.prefixes == ("toy.",)
    assert set(tracer.calls) == {"poisson_bootstrap", "segment_boot", "toy"}
    assert tracer.launches["toy"] == seen["launched"] \
        == len(tracer.calls["toy"]) > 100
    assert {name for name, _, _ in tr.spans} >= {"toy.answer", "toy.round"}
    assert not any(name.startswith("toy.") for name in tr.names)
    assert out["device"]["busy_s"] == tr.busy_s()
    assert not any(name.startswith("toy.") for name, _, _ in default.spans)
    if device == "cuda":
        # The default prefixes count the spans' device copies as work.
        assert any(name.startswith("toy.") for name in default.names)
        assert default.busy_s() > tr.busy_s() > 0
        print(f"toy on {torch.cuda.get_device_name(0)}: busy "
              f"{tr.busy_s()!r} s with toy., {default.busy_s()!r} s without;"
              f" device ops {tr.count_in_window()} / "
              f"{default.count_in_window()}; toy launches "
              f"{tracer.launches['toy']}, calls {len(tracer.calls['toy'])}, "
              f"window {tr.window_s!r} s")
    assert checkout_files() == before


@pytest.mark.parametrize("line", [
    'SPAN_PREFIXES = ("void",)', 'SPAN_PREFIXES = ("Memcpy.",)',
    'SPAN_PREFIXES = ("",)', 'KERNELS = {"poisson_bootstrap": KERNELS["toy"]}',
    'KERNELS = {"toy": dataclasses.replace(KERNELS["toy"], peak="fp64")}',
    'KERNELS = {"toy": dataclasses.replace(KERNELS["toy"], events=())}'])
def test_kind_with_a_malformed_tracing_role_is_refused(tmp_path, line):
    bench = write_toy(tmp_path, TOY_KIND + "\nimport dataclasses\n" + line)
    with pytest.raises(SystemExit):
        load_kind("toy_sums", here=bench)
    assert load_kind("toy_sums", here=write_toy(tmp_path / "sound"))
