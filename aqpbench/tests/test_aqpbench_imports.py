"""Nothing the command runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Module names are compared by
their whole top-level name: ``repro_torch`` begins with ``repro``."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def top_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_whole_name_compare():
    assert "repro_torch".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py"))
                         + sorted((HERE / "data").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_names(path)


def test_harness_loads_no_jax_at_run_time():
    code = ("import sys; sys.path[:0] = ['src', '.'];"
            "import aqpbench.harness, aqpbench.control, repro_torch.serve;"
            "from aqpbench.harness import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_harness_holds_no_kind():
    """What is built, sent and judged is the kind's: the harness imports no
    table, traffic, reference or serving code."""
    tree = ast.parse((HERE / "harness.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = "." * node.level + (node.module or "")
            names |= {base} | {f"{base}.{a.name}".replace("..", ".")
                               for a in node.names}
    kind_code = ("data", "lineitem", "reference", "exact", "judge",
                 "traffic", "generator", "repro_torch.serve",
                 "repro_torch.aqp")
    assert not {n for n in names for k in kind_code
                if k in n.split(".") or n.startswith(k)}, names
