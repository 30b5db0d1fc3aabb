"""The port stands alone: every module of ``repro_torch`` imports with JAX
made unimportable, and none of them pulls in the reference package."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import repro_torch

_SRC = Path(repro_torch.__file__).resolve().parents[1]
_ROOT = _SRC.parent

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any ``import jax`` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro.")
                or m == "jax" and sys.modules[m] is not None)
print(len(names), leaked)
assert not leaked, leaked
"""


def _run(code: str) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(_SRC)}
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(_ROOT), timeout=120)


def test_every_module_imports_without_jax_or_reference():
    out = _run(_PROBE)
    assert out.returncode == 0, out.stdout + out.stderr
    count = int(out.stdout.split()[0])
    expected = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                      "repro_torch.")]
    assert count == len(expected) >= 20
    for name in ("kernels.nvcc", "kernels.segment_agg.ops",
                 "kernels.segment_agg.ref", "kernels.decode_attention.ops",
                 "kernels.decode_attention.ref", "models.config",
                 "models.nn", "models.mlp", "models.attention",
                 "models.model", "models.ssm", "models.flops",
                 "configs.registry", "configs.qwen2_1_5b",
                 "configs.qwen3_1_7b", "configs.h2o_danube_3_4b",
                 "configs.command_r_plus_104b",
                 "configs.granite_moe_1b_a400m", "configs.deepseek_moe_16b",
                 "configs.rwkv6_7b", "configs.jamba_1_5_large_398b",
                 "configs.seamless_m4t_large_v2",
                 "configs.llama_3_2_vision_90b", "serve.batching",
                 "launch.serve", "core.baselines", "data.pipeline",
                 "integration", "integration.miss_eval",
                 "integration.miss_mixture", "integration.miss_router",
                 "train", "train.optimizer", "train.train_step",
                 "train.checkpoint", "train.compression", "train.elastic",
                 "train.pytree", "launch.train", "launch.specs"):
        assert f"repro_torch.{name}" in expected, name


def test_chip_smoke_imports_neither():
    """chip_smoke.py names no JAX and nothing of the reference."""
    text = (_ROOT / "chip_smoke.py").read_text()
    for bad in ("import jax", "from jax", "import repro\n", "from repro.",
                "from repro ", "import repro."):
        assert bad not in text, bad


_PLACEMENT = r"""
import sys
sys.modules["jax"] = None
import importlib
names = ["repro_torch.launch.mesh", "repro_torch.launch.sharding",
         "repro_torch.launch.hlo_analysis", "repro_torch.launch.dryrun",
         "repro_torch.models.shardctx", "repro_torch.core.sanitize"]
for name in names:
    importlib.import_module(name)
import torch.distributed as dist
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
assert not dist.is_initialized(), "a process group was initialised at import"
fake = [m for m in sys.modules if m.endswith("fake_pg")]
assert not fake, fake
print("ok", len(names))
"""


def test_placement_layer_imports_alone():
    """The placement layer, the dry run, its analysis and the sanitizer
    import without JAX or the reference, and importing them initialises
    no process group and loads no fake backend."""
    out = _run(_PLACEMENT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split() == ["ok", "6"]
