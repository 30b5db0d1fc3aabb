"""One cell of ``BENCHMARK.json``, found by name: its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``),
its limits (``checks/<workload>.json``) and the metrics it reports, each
per-layer metric read by ``metrics/<metric>.py``."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    chips: int
    limits: dict
    end_to_end: List[dict]      # entries of this cell's end-to-end metrics
    per_layer: List[dict]       # entries of this cell's per-layer metrics


def _reports(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[workload]
    cfg_entry = next(c for c in manifest["configs"] if c["name"] == w["config"])
    return Cell(
        name=workload,
        config=json.loads((root / cfg_entry["file"]).read_text()),
        mix=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        chips=int(w["chips"]),
        limits=json.loads((HERE / "checks" / f"{workload}.json").read_text()),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, workload)])


def reader(metric: str) -> Callable[[dict], object]:
    """``metrics/<metric>.py``'s ``read(run)``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"aqpbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
