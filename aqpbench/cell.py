"""One cell of ``BENCHMARK.json``, found by name: its configuration
(``configs/<config>.json``), the configuration's kind (``kinds/<kind>.py``,
named by the file's ``"kind"``, ``tpch_lineitem`` where it names none), its
traffic mix (``traffic/<traffic>.json``), its limits
(``checks/<workload>.json``) and the metrics it reports, each per-layer
metric read by ``metrics/<metric>.py``."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, List, Tuple

from . import devtrace, kernels
from .roofline import work

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DEFAULT_KIND = "tpch_lineitem"

# What a kind module holds, by role.  Besides, the tracing role may hold
# ``SPAN_PREFIXES``, the prefixes of the program's spans (none named:
# ``devtrace.DEFAULT_PREFIXES``), and ``KERNELS``, the kind's own
# ``kernels.Kernel`` entries by name beside ``kernels.SHARED``.
ROLES = {
    "build": ("make_data", "make_session", "make_traffic"),
    "client": ("Client",),
    "counters": ("counters", "describe"),
    "tracing": ("layer_spans",),
    "judging": ("answer", "judge", "EXACT_LIMITS", "READ_LIMITS"),
}


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    kind: ModuleType            # kinds/<config's kind>.py
    mix: dict
    chips: int
    limits: dict
    end_to_end: List[dict]      # entries of this cell's end-to-end metrics
    per_layer: List[dict]       # entries of this cell's per-layer metrics


def _reports(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def span_prefixes(kind: ModuleType) -> Tuple[str, ...]:
    """The prefixes of the kind's program spans."""
    return tuple(getattr(kind, "SPAN_PREFIXES", devtrace.DEFAULT_PREFIXES))


def load_kind(kind: str, here: Path = HERE) -> ModuleType:
    """``kinds/<kind>.py``, checked to fill every role of :data:`ROLES`,
    with well-formed span prefixes and kernels of its own."""
    mod = _load(here / "kinds" / f"{kind}.py", f"aqpbench_kind_{kind}")
    missing = [a for names in ROLES.values() for a in names
               if not hasattr(mod, a)]
    if missing:
        raise SystemExit(f"kind {kind!r} lacks {missing}")
    bad = [p for p in span_prefixes(mod)
           if not isinstance(p, str) or not devtrace.PREFIX.match(p)]
    if bad:
        raise SystemExit(f"kind {kind!r}: span prefixes {bad} do not match "
                         f"{devtrace.PREFIX.pattern}")
    own = getattr(mod, "KERNELS", {})
    bad = [n for n, k in own.items()
           if n in kernels.SHARED or not isinstance(k, kernels.Kernel)
           or not k.events or k.peak not in work.PEAKS]
    if bad:
        raise SystemExit(f"kind {kind!r}: kernels {bad} are shared, or lack "
                         f"device-op names or a known peak")
    return mod


def load_cell(workload: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[workload]
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    return Cell(
        name=workload,
        config=config,
        kind=load_kind(config.get("kind", DEFAULT_KIND), here),
        mix=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
        chips=int(w["chips"]),
        limits=json.loads((here / "checks" / f"{workload}.json").read_text()),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, workload)])


def reader(metric: str) -> Callable[[dict], object]:
    """``metrics/<metric>.py``'s ``read(run)``."""
    return _load(HERE / "metrics" / f"{metric}.py",
                 f"aqpbench_metric_{metric.replace('.', '_')}").read
