"""The production-mesh dry run (``launch/dryrun.py``) and its analysis
(``launch/hlo_analysis.py``) on a fake process group of 256 ranks.

The cells trace reduced configs (``reduced_for_smoke``) at the registry's
real shapes on the 16x16 mesh: every tensor is on the ``meta`` device, so
the shapes cost nothing.  The fake group is torn down after the module, so
no other test meets it.
"""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_shape
from repro_torch.launch import dryrun, hlo_analysis, sharding, specs
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import model as M
from repro_torch.models.config import reduced_for_smoke

META = torch.device("meta")
MESH = MeshShape((16, 16), ("data", "model"))
CELLS = [("qwen2-1.5b", "train_4k"), ("granite-moe-1b-a400m", "prefill_32k"),
         ("qwen3-1.7b", "decode_32k")]


@pytest.fixture(scope="module")
def fake256():
    assert not dist.is_initialized()
    dryrun.fake_world(256)
    yield
    dist.destroy_process_group()


def _spec_bytes(tree, spec_tree) -> int:
    """Per-rank bytes of ``tree`` placed by ``spec_tree`` on the 16x16
    mesh: each leaf's bytes over the sizes of the axes its spec names."""
    sizes = dict(zip(MESH.mesh_dim_names, MESH.shape))
    total = 0
    for x, spec in zip(sharding.pytree.leaves(tree),
                       sharding.spec_list(spec_tree)):
        div = 1
        for entry in spec:
            for a in (() if entry is None else entry if isinstance(
                    entry, tuple) else (entry,)):
                div *= sizes[a]
        n = x.numel() * x.element_size()
        assert n % div == 0
        total += n // div
    return total


def _arg_bytes(cfg, shape_name) -> int:
    from repro_torch.train.optimizer import adamw_init
    shp = get_shape(shape_name)
    params = M.trainable(M.init_model(cfg, 0, META))
    p_sh = sharding.param_shardings(params, MESH)
    total = _spec_bytes(params, p_sh)
    if shp.kind == "train":
        opt = adamw_init(dryrun._train_cfg(cfg.name).optimizer, params)
        total += _spec_bytes(opt, sharding.opt_shardings(opt, p_sh, MESH))
        batch = specs.batch_specs(cfg, seq_len=shp.seq_len,
                                  global_batch=shp.global_batch)
        return total + _spec_bytes(batch, sharding.batch_shardings(
            batch, MESH))
    if shp.kind == "prefill":
        batch = specs.batch_specs(cfg, seq_len=shp.seq_len,
                                  global_batch=shp.global_batch,
                                  with_labels=False)
        return total + _spec_bytes(batch, sharding.batch_shardings(
            batch, MESH))
    token = specs.decode_token_spec(cfg, shp.global_batch)
    caches = specs.cache_specs(cfg, global_batch=shp.global_batch,
                               kv_len=shp.seq_len)
    return (total + _spec_bytes(token, sharding.batch_shardings(token, MESH))
            + _spec_bytes(caches, sharding.cache_shardings(
                caches, MESH, batch=shp.global_batch)))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_ok_with_spec_arithmetic(fake256, arch, shape):
    cfg = reduced_for_smoke(get_config(arch))
    rec = dryrun.run_cell(arch, shape, multi_pod=False, cfg=cfg, write=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["memory_analysis"]["argument_size_in_bytes"] == \
        _arg_bytes(cfg, shape)
    assert rec["cost_analysis"]["flops"] > 0
    assert rec["cost_analysis"]["bytes accessed"] > 0
    coll = rec["collective_bytes"]
    assert coll["total"] == sum(coll[k] for k in hlo_analysis.KINDS)
    assert coll["total"] > 0 and sum(coll["counts"].values()) > 0
    terms = rec["roofline"]
    assert terms["dominant"] in ("compute", "memory", "collective")
    assert terms["chips"] == 256
    assert rec["model_flops"] > 0 and rec["params_total"] > 0
    json.dumps(rec)


def test_inapplicable_cell_skipped(tmp_path):
    rec = dryrun.run_cell("qwen2-1.5b", "long_500k", multi_pod=False,
                          out_dir=str(tmp_path))
    assert rec["status"] == "skipped" and "quadratic" in rec["reason"]
    with open(tmp_path / "qwen2-1.5b__long_500k__16x16.json") as f:
        assert json.load(f)["status"] == "skipped"


def test_cli_writes_a_cell(fake256, tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: reduced_for_smoke(get_config(arch)))
    out = dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                       "--out", str(tmp_path), "--analysis"])
    assert [r["status"] for r in out] == ["ok"]
    with open(tmp_path / "qwen3-1.7b__decode_32k__16x16.json") as f:
        assert json.load(f)["status"] == "ok"
    again = dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                         "--out", str(tmp_path), "--skip-done"])
    assert again[0]["status"] == "ok"


def test_collective_bytes_of_a_sharded_matmul(fake256):
    """By hand: a column-sharded product gathered whole is one all-gather
    of the (B, N) result; a row-sharded one is a pending sum that one
    all-reduce of (B, N) settles.  f32: 4 bytes an element."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = dryrun.production_mesh(False)
    B, K, N = 64, 256, 512
    x = distribute_tensor(torch.empty(B, K, device=META), mesh,
                          [Replicate(), Replicate()], src_data_rank=None)
    w_col = distribute_tensor(torch.empty(K, N, device=META), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)
    rec = hlo_analysis.CollectiveRecord()
    with rec:
        y = (x @ w_col).full_tensor()
    assert tuple(y.shape) == (B, N)
    got = hlo_analysis.collective_bytes(rec)
    assert got["counts"]["all-gather"] == 1 and got["all-gather"] == B * N * 4
    assert got["total"] == B * N * 4

    xk = distribute_tensor(torch.empty(B, K, device=META), mesh,
                           [Replicate(), Shard(1)], src_data_rank=None)
    w_row = distribute_tensor(torch.empty(K, N, device=META), mesh,
                              [Replicate(), Shard(0)], src_data_rank=None)
    rec = hlo_analysis.CollectiveRecord()
    with rec:
        (xk @ w_row).full_tensor()
    got = hlo_analysis.collective_bytes(rec)
    assert got["counts"]["all-reduce"] == 1 and got["all-reduce"] == B * N * 4
    assert got["total"] == B * N * 4
    assert sum(got["counts"].values()) == 1


def test_collective_kinds():
    pairs = [("all_gather_into_tensor", 10), ("all_reduce", 20),
             ("reduce_scatter_tensor", 30), ("all_to_all_single", 40),
             ("permute_tensor", 50), ("wait_tensor", 60)]
    got = hlo_analysis.collective_bytes(pairs)
    assert [got[k] for k in hlo_analysis.KINDS] == [10, 20, 30, 40, 50]
    assert got["total"] == 150
    assert all(c == 1 for c in got["counts"].values())


def test_roofline_terms_dominance_h100():
    t = hlo_analysis.roofline_terms(flops=989e12, bytes_=3.35e12 * 3,
                                    coll_bytes=450e9 * 2, chips=256)
    assert t["dominant"] == "memory"
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["t_memory_s"] == pytest.approx(3.0)
    assert t["t_collective_s"] == pytest.approx(2.0)
    t = hlo_analysis.roofline_terms(flops=989e12 * 5, bytes_=0.0,
                                    coll_bytes=0.0, chips=512)
    assert t["dominant"] == "compute"
    t = hlo_analysis.roofline_terms(flops=0.0, bytes_=1.0, coll_bytes=450e9,
                                    chips=256)
    assert t["dominant"] == "collective"
    assert hlo_analysis.PEAK_FLOPS_BF16 == 989e12
    assert hlo_analysis.HBM_BW == 3.35e12
    assert hlo_analysis.NVLINK_BW == 450e9


def test_model_flops_ratio_is_ideal_share_over_rank_flops(fake256):
    cfg = reduced_for_smoke(get_config("qwen2-1.5b"))
    rec = dryrun.run_cell("qwen2-1.5b", "decode_32k", multi_pod=False,
                          cfg=cfg, write=False)
    assert rec["model_flops_ratio"] == pytest.approx(
        rec["model_flops"] / (rec["cost_analysis"]["flops"] * 256))
    assert np.isfinite(rec["roofline"]["t_memory_s"])
