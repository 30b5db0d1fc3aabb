"""The command itself: no card, no result; no program, no result."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "sf10_shipinstruct.solo_open", "--seed", str(2**31 + 3),
        "--seconds", "1", "--trace", "0"]


def test_without_a_card_it_prints_no_result(monkeypatch):
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "aqpbench/run.py", *ARGS],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in m["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, *m["command"][1:], *ARGS],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
