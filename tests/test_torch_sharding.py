"""The port's placement layer (``launch/mesh.py``, ``launch/sharding.py``,
``models/shardctx.py``) against the reference's spec functions.

Metadata only: both packages compute partition specs from names, shapes and
mesh axis sizes, so a mesh here is its shape and axis names (the port's
``MeshShape``; the reference's functions read ``mesh.axis_names`` and
``mesh.devices.shape``, which a stand-in class gives them).  The reference
wraps its specs in ``NamedSharding``, which needs a real device mesh; the
tests read the bare specs by standing ``NamedSharding`` in with
``lambda mesh, spec: spec``.

The reference stacks each pattern position over repeats (a leading axis its
specs pad with ``None``); the port keeps one dict per layer, so a port
leaf's spec is the reference leaf's without its first entry.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.launch import sharding as jsh
from repro.launch import specs as jspecs
from repro.models import model as JM
from repro.models import shardctx as jctx
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import sharding as sh
from repro_torch.launch import specs
from repro_torch.launch.mesh import MeshShape, dp_axes
from repro_torch.models import model as M
from repro_torch.models import shardctx as ctx
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import MambaState
from repro_torch.train import pytree
from repro_torch.train.optimizer import AdamWConfig, adamw_init

META = torch.device("meta")
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class JFakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, object)


def meshes(name):
    shape, axes = MESHES[name]
    return MeshShape(shape, axes), JFakeMesh(shape, axes)


@pytest.fixture
def bare_specs(monkeypatch):
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)


def _ref_path(path: str, cfg):
    """The reference path (and whether it is stacked) of a port path."""
    parts = path.split("/")
    if parts[0] in ("layers", "enc", "dec"):
        stack = "blocks" if parts[0] == "layers" else parts[0]
        n_pos = len(cfg.layer_pattern) if stack == "blocks" else 1
        pos = int(parts[1]) % n_pos
        return "/".join([stack, str(pos)] + parts[2:]), True
    return path, False


def _ref_param_specs(cfg, jmesh):
    abs_params = jax.eval_shape(lambda: JM.init_model(
        cfg, jax.random.PRNGKey(0)))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(abs_params)[0]:
        p = jsh._path_str(path)
        spec = jsh._shardable(jsh._spec_for(p, len(leaf.shape), jmesh),
                              leaf.shape, jmesh)
        out[p] = (tuple(spec), tuple(leaf.shape))
    return out


def test_archs_agree():
    assert tuple(ARCHS) == tuple(JARCHS)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh_name):
    """Every port leaf's spec is the reference leaf's, less the repeat
    axis; the shapes agree likewise; every leaf of both trees is met."""
    mesh, jmesh = meshes(mesh_name)
    params = M.trainable(M.init_model(get_config(arch), 0, META))
    ref = _ref_param_specs(jget_config(arch), jmesh)
    seen = set()
    specs_ = sh.spec_list(sh.param_shardings(params, mesh))
    n_sharded = 0
    for (path, leaf), spec in zip(sh.paths(params), specs_):
        rpath, stacked = _ref_path(path, get_config(arch))
        rspec, rshape = ref[rpath]
        if stacked:
            rspec, rshape = rspec[1:], rshape[1:]
        assert tuple(leaf.shape) == rshape, path
        assert tuple(spec) == rspec, (path, spec, rspec)
        n_sharded += any(a is not None for a in spec)
        seen.add(rpath)
    assert seen == set(ref)
    assert n_sharded >= 4


def test_tied_head_takes_the_embedding_spec():
    cfg = get_config("qwen2-1.5b")
    mesh, _ = meshes("16x16")
    full = M.init_model(cfg, 0, META)
    specs_ = sh.param_shardings({"embed": full["embed"],
                                 "tied_head": full["tied_head"]}, mesh)
    assert specs_["tied_head"] == specs_["embed"] == ctx.P("model", "data")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_opt_specs_match_reference(mesh_name, bare_specs):
    cfg = get_config("granite-moe-1b-a400m")
    mesh, jmesh = meshes(mesh_name)
    params = M.trainable(M.init_model(cfg, 0, META))
    opt = adamw_init(AdamWConfig(master_fp32=True), params)
    p_sh = sh.param_shardings(params, mesh)
    o_sh = sh.opt_shardings(opt, p_sh, mesh)
    assert o_sh["step"] == ctx.P()
    for key in ("mu", "nu", "master"):
        assert o_sh[key] is p_sh
    jo = jsh.opt_shardings({"step": 0, "mu": 1, "nu": 2, "master": 3},
                           "PSH", jmesh)
    assert tuple(jo["step"]) == () and jo["mu"] == jo["master"] == "PSH"


@pytest.mark.parametrize("batch", [256, 1])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "seamless-m4t-large-v2",
                                  "llama-3.2-vision-90b"])
def test_batch_specs_match_reference(arch, mesh_name, batch, bare_specs):
    mesh, jmesh = meshes(mesh_name)
    for shard_batch in (True, False):
        got = sh.batch_shardings(specs.batch_specs(
            get_config(arch), seq_len=4096, global_batch=batch), mesh,
            shard_batch=shard_batch)
        want = jsh.batch_shardings(jspecs.batch_specs(
            jget_config(arch), seq_len=4096, global_batch=batch), jmesh,
            shard_batch=shard_batch)
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k]) == tuple(want[k]), (k, got[k], want[k])


def _ref_entry(port_entry, ref_entry):
    """The reference's per-position cache entry for a port layer's entry:
    its ``mixer`` for an attention or Mamba layer (the port holds those
    bare), the whole dict otherwise."""
    if isinstance(port_entry, (KVCache, MambaState)):
        return ref_entry["mixer"]
    return ref_entry


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh_name, shape, bare_specs):
    from repro_torch.configs import get_shape
    shp = get_shape(shape)
    mesh, jmesh = meshes(mesh_name)
    cfg, jcfg = get_config(arch), jget_config(arch)
    caches = specs.cache_specs(cfg, global_batch=shp.global_batch,
                               kv_len=shp.seq_len)
    got = sh.cache_shardings(caches, mesh, batch=shp.global_batch)
    jcaches = jspecs.cache_specs(jcfg, global_batch=shp.global_batch,
                                 kv_len=shp.seq_len)
    want = jsh.cache_shardings(jcaches, jmesh, batch=shp.global_batch)
    n_pos = len(want)
    for i, (c, s) in enumerate(zip(caches, got)):
        rc = _ref_entry(c, jcaches[i % n_pos])
        rs = _ref_entry(c, want[i % n_pos])
        leaves = pytree.leaves(c)
        ps = sh.spec_list(s)
        rleaves = jax.tree.leaves(rc)
        rspecs = jax.tree.leaves(rs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
        assert len(leaves) == len(ps) == len(rleaves) == len(rspecs), i
        for x, p, rx, rp in zip(leaves, ps, rleaves, rspecs):
            assert tuple(x.shape) == tuple(rx.shape)[1:]
            assert tuple(p) == tuple(rp)[1:], (i, type(c), p, rp)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_logits_sharding_matches_reference(mesh_name, bare_specs):
    mesh, jmesh = meshes(mesh_name)
    for shard_batch in (True, False):
        assert tuple(sh.logits_sharding(mesh, shard_batch=shard_batch)) == \
            tuple(jsh.logits_sharding(jmesh, shard_batch=shard_batch))


def _specs_as_tuples(d):
    return {k: (None if v is None else tuple(v)) for k, v in d.items()}


@pytest.mark.parametrize("batch_shardable", [True, False])
@pytest.mark.parametrize("n_heads", [12, 16, None])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_make_rules_match_reference(mesh_name, n_heads, batch_shardable):
    mesh, jmesh = meshes(mesh_name)
    got = ctx.make_rules(mesh, batch_shardable=batch_shardable,
                         n_heads=n_heads)
    want = jctx.make_rules(jmesh, batch_shardable=batch_shardable,
                           n_heads=n_heads)
    assert got["mesh"] is mesh
    assert _specs_as_tuples(got["specs"]) == _specs_as_tuples(want["specs"])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_fits_matches_reference(mesh_name):
    mesh, jmesh = meshes(mesh_name)
    dp = dp_axes(mesh)
    dp = dp if len(dp) > 1 else dp[0]
    cases = [((dp, None, "model"), (256, 4096, 151_936)),
             ((dp, None, "model"), (8, 4096, 12)),
             ((dp, "model", None), (512, 8, 1536)),
             ((None, dp, None), (1, 524_288, 1536)),
             ((dp, None, None, "model", None), (16, 2, 6, 4096, 4096)),
             (("model",), (15,)), (("model", "data"), (8, 32))]
    for spec, shape in cases:
        got = ctx._fits(ctx.P(*spec), shape, mesh)
        want = jctx._fits(jax.sharding.PartitionSpec(*spec), shape, jmesh)
        assert tuple(got) == tuple(want), (spec, shape)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MeshShape((2, 16, 16), ("pod", "data", "model"))
    assert ctx.to_placements(ctx.P(("pod", "data"), None, "model"), mesh) \
        == [Shard(0), Shard(0), Shard(2)]
    assert ctx.to_placements(ctx.P(), mesh) == [Replicate()] * 3
    assert ctx.to_placements(ctx.P(None, "data"), mesh) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError, match="mesh order"):
        ctx.to_placements(ctx.P(("data", "pod")), mesh)


def test_constrain_is_the_identity_without_rules_or_dtensors():
    x = torch.randn(2, 3, 4)
    for kind in ("resid", "heads", "ffn", "logits", "scores", "experts"):
        assert ctx.constrain(x, kind) is x
    rules = ctx.make_rules(MeshShape((16, 16), ("data", "model")),
                           n_heads=12)
    with ctx.use_rules(rules):
        assert ctx.constrain(x, "resid") is x          # a plain tensor


def test_place_on_one_rank_is_the_identity():
    params = M.init_model(get_config("qwen2-1.5b"), 0, META)
    mesh = MeshShape((1, 1), ("data", "model"))
    specs_ = sh.param_shardings(params, mesh)
    assert sh.place(params, specs_, mesh) is params
