"""Sharded training on a mesh of four gloo ranks against one rank.

One launch of four ``python -c`` ranks (``OMP_NUM_THREADS=1``, a ``file://``
store, 240 s limit) on a (2, 2) ``("data", "model")`` mesh drives every
scenario; rank 0 writes what the tests read:

* ``launch.train``'s loop on a ``make_local_mesh(2)`` mesh of a reduced
  dense arch (Qwen2: QKV biases, tied head) and a reduced MoE arch
  (Granite-MoE): parameters placed by ``param_shardings`` as they are
  drawn, moments mirroring them, batches by ``batch_shardings``, each step
  under the activation rules.  Its losses, gathered parameters and moments
  equal a one-rank run of the same steps: losses and params within rtol
  2e-4 / atol 2e-5, the moments (the gradients) within 2e-4 of each leaf's
  largest magnitude, and each leaf's change over the run (params less
  their initial draw) within UPDATE_TOL of the one-rank change's largest
  magnitude -- the check that the sharded optimizer applied its update to
  every shard, which the params' atol alone cannot see at this lr.  As in
  the card-vs-CPU training check, the runs take lr 1e-5: Adam's first
  steps move an element by about lr * sign(g), so an element whose
  gradient lies within f32 noise of zero may move either way, and at lr
  1e-5 such a move stays inside atol;
* the elastic restart: the Qwen2 run's checkpoint, saved whole from the
  (2, 2) mesh, restored onto a (4, 1) mesh and gathered equals the (2, 2)
  state bit for bit, and so does a restore on one rank (no mesh) here;
* ``make_pod_gradient_sync`` over the ``"pod"`` axis of a (2, 2) ``("pod",
  "data")`` DeviceMesh: each rank's pod group of two reduces as
  ``compressed_psum`` does; a mesh without a pod axis is the identity;
* a reduced Qwen2 placed on the (2, 2) mesh as ``init_model`` draws it:
  ``prefill`` and three ``decode_step``s on placed caches (rows over
  "data", positions over "model": each rank's part through the
  decode-attention op, the two parts merged by log-sum-exp) equal the
  plain model's logits;
* the sharded decode's attention alone, on the same placement: rows
  whose length falls before, on and past the parts' boundary and past
  ``S_max``, with and without a sliding window, and cross-attention over a
  placed memory, against the plain layer -- outputs and the caches
  written in place.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import sharding
from repro_torch.launch import train as T
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import pytree

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
ARCHS = ("qwen2-1.5b", "granite-moe-1b-a400m")
STEPS = 3
TRAIN = ["--smoke", "--device", "cpu", "--steps", str(STEPS), "--batch", "8",
         "--seq", "32", "--lr", "1e-5", "--seed", "0"]
TOL = dict(rtol=2e-4, atol=2e-5)
MOMENT_TOL = 2e-4
UPDATE_TOL = 5e-2

RANK_CODE = r"""
import sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, out, ck = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4], sys.argv[5])
archs, train = sys.argv[6].split(","), sys.argv[7].split()
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
from torch.distributed.tensor import DTensor
from repro_torch.launch import sharding, train as T
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt, compression as comp
res = {}

def put(tag, tree):
    for path, x in sharding.paths(sharding.full(tree)):
        res[tag + "/" + path] = x.numpy()

for arch in archs:
    extra = ["--ckpt", ck, "--ckpt-every", "3"] if arch == archs[0] else []
    mesh = make_local_mesh(2, device_type="cpu")
    r = T._train(T.parse_args(["--arch", arch] + train + extra),
                 torch.device("cpu"), mesh)
    res[arch + "/mesh"] = np.asarray(tuple(mesh.shape))
    res[arch + "/losses"] = np.asarray(r["losses"])
    params = M.trainable(r["params"])
    res[arch + "/dtensors"] = np.asarray(all(
        isinstance(x, DTensor) for x in sharding.pytree.leaves(params)))
    res[arch + "/local_bytes"] = np.asarray(sum(
        x.to_local().numel() * x.element_size()
        for x in sharding.pytree.leaves(params)))
    put(arch + "/p", params)
    put(arch + "/mu", r["opt_state"]["mu"])
    put(arch + "/nu", r["opt_state"]["nu"])

"""


def _run_ranks(tmp: Path) -> dict:
    code = RANK_CODE + ELASTIC_CODE
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(ROOT / "src")}
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(WORLD), str(tmp / "store"),
         str(tmp / "rank"), str(tmp / "ckpt"), ",".join(ARCHS),
         " ".join(TRAIN)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return dict(np.load(tmp / "rank0.npz"))


ELASTIC_CODE = r"""# -- elastic: the (2, 2) run's checkpoint onto a (4, 1) mesh ---
dist.barrier()
mesh41 = make_local_mesh(1, device_type="cpu")
res["elastic/mesh"] = np.asarray(tuple(mesh41.shape))
step = ckpt.latest_step(ck)
res["elastic/step"] = np.asarray(step)
from repro_torch.models.config import reduced_for_smoke
from repro_torch.train.optimizer import AdamWConfig, adamw_init
like_p = M.trainable(M.init_model(reduced_for_smoke(T.get_config(archs[0])),
                                  1, "cpu"))
like = {"params": like_p, "opt": adamw_init(AdamWConfig(), like_p)}
p_sh = sharding.param_shardings(like_p, mesh41)
state = ckpt.restore(ck, step, like, {"params": p_sh, "opt":
                     sharding.opt_shardings(like["opt"], p_sh, mesh41)},
                     mesh=mesh41)
res["elastic/dtensors"] = np.asarray(all(
    isinstance(x, DTensor) and x.device_mesh.shape == (4, 1)
    for x in sharding.pytree.leaves(state["params"])))
put("elastic/p", state["params"])
put("elastic/mu", state["opt"]["mu"])
put("elastic/nu", state["opt"]["nu"])

# -- the pod gradient sync over a ("pod", "data") DeviceMesh -----------------
from torch.distributed.device_mesh import init_device_mesh
pod = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
g = np.random.default_rng(300 + rank)
x = (g.standard_normal(256) * 10.0 ** (rank - 2)).astype(np.float32)
rr = (g.standard_normal(256) * 10.0 ** (rank - 4)).astype(np.float32)
sync = comp.make_pod_gradient_sync(pod)
gs, rs = sync({"a": torch.from_numpy(x)}, {"a": torch.from_numpy(rr)})
res["pod/g"], res["pod/r"] = gs["a"].numpy(), rs["a"].numpy()
ident = comp.make_pod_gradient_sync(mesh41)
gi, ri = ident({"a": torch.from_numpy(x)}, {"a": torch.from_numpy(rr)})
res["pod/identity"] = np.asarray(gi["a"].numpy().tobytes() == x.tobytes())

# -- prefill and decode on the (2, 2) mesh against the plain model ----------
from repro_torch.models import shardctx
mesh22 = make_local_mesh(2, device_type="cpu")
cfg = reduced_for_smoke(T.get_config(archs[0]))
sharded = M.init_model(cfg, 3, "cpu", place=sharding.placer(mesh22))
plain = M.init_model(cfg, 3, "cpu")
rules = shardctx.make_rules(mesh22, n_heads=cfg.n_heads)
g = torch.Generator().manual_seed(5)
prompt = torch.randint(0, cfg.vocab_size, (4, 12), generator=g,
                       dtype=torch.int32)
bs = sharding.batch_shardings({"tokens": prompt}, mesh22)
with shardctx.use_rules(rules), shardctx.mixed():
    lg, _, _ = M.prefill(cfg, sharded, sharding.place({"tokens": prompt},
                                                      bs, mesh22))
res["prefill/sharded"] = lg.full_tensor().numpy()
res["prefill/plain"] = M.prefill(cfg, plain, {"tokens": prompt})[0].numpy()
dc = M.init_caches(cfg, 4, 16, device="cpu")
dc = sharding.place(dc, sharding.cache_shardings(dc, mesh22, batch=4),
                    mesh22)
pc = M.init_caches(cfg, 4, 16, device="cpu")
for t in range(3):
    tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=g,
                        dtype=torch.int32)
    dtok = sharding.place(tok, sharding.batch_shardings(tok, mesh22), mesh22)
    with shardctx.use_rules(rules), shardctx.mixed():
        lg, dc = M.decode_step(cfg, sharded, dtok, dc)
    lp, pc = M.decode_step(cfg, plain, tok, pc)
    res[f"decode/{t}/sharded"] = lg.full_tensor().numpy()
    res[f"decode/{t}/plain"] = lp.numpy()
res["decode/placed"] = np.asarray(isinstance(dc[0].k, DTensor))
res["decode/split"] = np.asarray(
    [any(pl.is_shard(1) for pl in dc[0].k.placements)])

# -- the sharded decode's attention alone ------------------------------------
import dataclasses
from torch.distributed.tensor import Replicate, distribute_tensor
from repro_torch.models import attention as A
whole = [Replicate(), Replicate()]
g = torch.Generator().manual_seed(11)
for tag, W in (("full", None), ("window", 5), ("cross", None)):
    acfg = dataclasses.replace(cfg, sliding_window=W)
    ap = A.init_attn(g, acfg, torch.float32, "cpu", cross=tag == "cross")
    dp = {k: distribute_tensor(v, mesh22, whole, src_data_rank=None)
          for k, v in ap.items()}
    x = torch.randn((4, 1, cfg.d_model), generator=g)
    dx = sharding.place(x, sharding.batch_shardings(x, mesh22), mesh22)
    kv = tuple(torch.randn((4, 16, cfg.n_kv_heads, cfg.head_dim),
                           generator=g) for _ in range(2))
    if tag == "cross":
        dkv = sharding.place(kv, sharding.cache_shardings(kv, mesh22,
                                                          batch=4), mesh22)
        with shardctx.use_rules(rules), shardctx.mixed():
            so = A.cross_attention(dp, acfg, dx, dkv)
        res[f"attn/{tag}/sharded"] = so.full_tensor().numpy()
        res[f"attn/{tag}/plain"] = A.cross_attention(ap, acfg, x, kv).numpy()
        continue
    lens = torch.tensor([3, 7, 8, 17], dtype=torch.int32)
    pc = A.KVCache(kv[0].clone(), kv[1].clone(), lens.clone())
    sc = A.KVCache(*kv, lens)
    sc = sharding.place(sc, sharding.cache_shardings(sc, mesh22, batch=4),
                        mesh22)
    with shardctx.use_rules(rules), shardctx.mixed():
        so, sc = A.decode_self_attention(dp, acfg, dx, sc)
    po, pc = A.decode_self_attention(ap, acfg, x, pc)
    res[f"attn/{tag}/sharded"] = so.full_tensor().numpy()
    res[f"attn/{tag}/plain"] = po.numpy()
    for i, name in enumerate(("k", "v", "length")):
        res[f"attn/{tag}/{name}/sharded"] = sc[i].full_tensor().numpy()
        res[f"attn/{tag}/{name}/plain"] = pc[i].numpy()
np.savez(out + str(rank) + ".npz", **res)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_train")
    return tmp, _run_ranks(tmp)


@pytest.fixture(scope="module")
def one_rank():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {arch: T.run(["--arch", arch] + TRAIN) for arch in ARCHS}
    finally:
        torch.set_num_threads(threads)


def _leaf_close(got, want, what, moment=False):
    assert got.shape == want.shape, what
    if moment:
        err = np.abs(got - want).max()
        assert err <= MOMENT_TOL * np.abs(want).max(), (what, err)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_one_rank(ranks, one_rank, arch):
    _, z = ranks
    ref = one_rank[arch]
    assert tuple(z[arch + "/mesh"]) == (2, 2)
    assert bool(z[arch + "/dtensors"])
    np.testing.assert_allclose(z[arch + "/losses"], ref["losses"],
                               rtol=2e-4)
    assert np.all(np.isfinite(z[arch + "/losses"]))
    trees = {"p": M.trainable(ref["params"]), "mu": ref["opt_state"]["mu"],
             "nu": ref["opt_state"]["nu"]}
    n = 0
    for tag, tree in trees.items():
        for path, x in sharding.paths(tree):
            _leaf_close(z[f"{arch}/{tag}/{path}"], x.numpy(),
                        f"{arch} {tag} {path}", moment=tag != "p")
            n += 1
    assert n == 3 * len(pytree.leaves(M.trainable(ref["params"])))
    # The update: each leaf's change against the one-rank change.
    from repro_torch.models.config import reduced_for_smoke
    p0 = M.trainable(M.init_model(reduced_for_smoke(T.get_config(arch)), 0,
                                  "cpu"))
    worst = 0.0
    for (path, x0), x in zip(sharding.paths(p0), pytree.leaves(
            trees["p"])):
        want = (x - x0).numpy()
        got = z[f"{arch}/p/{path}"] - x0.numpy()
        scale = np.abs(want).max()
        assert scale > 0, f"{arch} {path}: the one-rank run left it"
        err = np.abs(got - want).max() / scale
        worst = max(worst, err)
        assert err <= UPDATE_TOL, (arch, path, err)
    print(f"{arch}: worst update error {worst:.3g} of the leaf's change")


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_leaves_hold_their_spec_share(ranks, one_rank, arch):
    """Each rank holds its shards: local bytes are the spec arithmetic
    (a dim over an axis of 2 holds half), far below the whole tree."""
    from repro_torch.launch.mesh import MeshShape
    _, z = ranks
    params = M.trainable(one_rank[arch]["params"])
    mesh = MeshShape((2, 2), ("data", "model"))
    want = 0
    for (path, x), spec in zip(sharding.paths(params), sharding.spec_list(
            sharding.param_shardings(params, mesh))):
        div = 1
        for entry in spec:
            div *= 1 if entry is None else 2
        want += x.numel() * x.element_size() // div
    assert int(z[arch + "/local_bytes"]) == want
    total = sum(x.numel() * x.element_size() for x in pytree.leaves(params))
    assert want < total / 2


def test_elastic_restore_bit_equal(ranks):
    tmp, z = ranks
    arch = ARCHS[0]
    assert tuple(z["elastic/mesh"]) == (4, 1)
    assert bool(z["elastic/dtensors"])
    step = int(z["elastic/step"])
    assert step == STEPS - 1
    keys = [k for k in z if k.startswith("elastic/") and k.count("/") >= 2]
    assert len(keys) > 30
    for k in keys:
        tag, path = k.split("/", 2)[1:]
        assert z[k].tobytes() == z[f"{arch}/{tag}/{path}"].tobytes(), k
    # ... and on one rank, with no mesh at all.
    from repro_torch.models.config import reduced_for_smoke
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    lp = M.trainable(M.init_model(reduced_for_smoke(T.get_config(arch)), 1,
                                  "cpu"))
    state = ckpt.restore(str(tmp / "ckpt"), step,
                         {"params": lp, "opt": adamw_init(AdamWConfig(), lp)})
    for tag, tree in (("p", state["params"]), ("mu", state["opt"]["mu"]),
                      ("nu", state["opt"]["nu"])):
        for path, x in sharding.paths(tree):
            assert not hasattr(x, "device_mesh")
            assert x.numpy().tobytes() == \
                z[f"{arch}/{tag}/{path}"].tobytes(), (tag, path)


def _numpy_pod_psum(xs, rs):
    f32 = np.float32
    scales = [np.maximum(np.max(np.abs(x + r)) / f32(127.0), f32(1e-12))
              for x, r in zip(xs, rs)]
    scale_max = np.max(np.asarray(scales, f32))
    qs = [np.clip(np.round((x + r) / scale_max), -127, 127).astype(np.int8)
          for x, r in zip(xs, rs)]
    total = np.sum([q.astype(np.int32) for q in qs], axis=0, dtype=np.int32)
    resid = (xs[0] + rs[0]) - qs[0].astype(f32) * scale_max
    return total.astype(f32) * scale_max / f32(len(xs)), resid


def test_pod_gradient_sync_over_a_device_mesh(ranks):
    """Rank 0's pod group on a (2, 2) ("pod", "data") mesh is ranks 0 and
    2 (same data coordinate)."""
    _, z = ranks
    xs, rs = [], []
    for rank in (0, 2):
        g = np.random.default_rng(300 + rank)
        xs.append((g.standard_normal(256) * 10.0 ** (rank - 2)).astype(
            np.float32))
        rs.append((g.standard_normal(256) * 10.0 ** (rank - 4)).astype(
            np.float32))
    want_g, want_r = _numpy_pod_psum(xs, rs)
    assert z["pod/g"].tobytes() == want_g.tobytes()
    assert z["pod/r"].tobytes() == want_r.tobytes()
    assert bool(z["pod/identity"])


def test_mesh_local_on_one_device_is_the_plain_step(one_rank):
    """``--mesh local`` with no group initialised: a one-rank group made
    for the run and torn down after it, a (1, 1) mesh on which every
    placement is trivial, and the same plain tensors as the step loop
    without any mesh -- losses and params bit for bit."""
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    from repro_torch.models.config import reduced_for_smoke
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import TrainConfig, build_train_step

    out = one_rank["qwen2-1.5b"]
    assert tuple(out["mesh"].shape) == (1, 1)
    assert not dist.is_initialized()
    cfg = reduced_for_smoke(get_config("qwen2-1.5b"))
    tcfg = TrainConfig(optimizer=AdamWConfig(lr_peak=1e-5, warmup_steps=5,
                                             total_steps=10), remat=None)
    init_fn, step_fn = build_train_step(cfg, tcfg)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params, opt = init_fn(0, "cpu")
        losses = []
        for step in range(STEPS):
            batch = pipeline.batch_for_step(
                step, global_batch=8, seq_len=32, vocab=cfg.vocab_size,
                seed=0, device="cpu", **pipeline.batch_kwargs_for(cfg, 32))
            params, opt, m = step_fn(params, opt, batch)
            losses.append(float(m["loss"]))
    finally:
        torch.set_num_threads(threads)
    assert losses == out["losses"]
    for (path, x), y in zip(sharding.paths(M.trainable(params)),
                            pytree.leaves(M.trainable(out["params"]))):
        assert x.numpy().tobytes() == y.numpy().tobytes(), path


def test_sharded_prefill_and_decode_equal_plain(ranks):
    _, z = ranks
    assert bool(z["decode/placed"]) and bool(z["decode/split"][0])
    np.testing.assert_allclose(z["prefill/sharded"], z["prefill/plain"],
                               **TOL)
    for t in range(3):
        np.testing.assert_allclose(z[f"decode/{t}/sharded"],
                                   z[f"decode/{t}/plain"], **TOL)


@pytest.mark.parametrize("tag", ["full", "window", "cross"])
def test_sharded_decode_attention_equals_plain(ranks, tag):
    _, z = ranks
    np.testing.assert_allclose(z[f"attn/{tag}/sharded"],
                               z[f"attn/{tag}/plain"], **TOL)
    if tag == "cross":
        return
    for name in ("k", "v", "length"):
        assert z[f"attn/{tag}/{name}/sharded"].tobytes() == \
            z[f"attn/{tag}/{name}/plain"].tobytes(), name


CUDA_DECODE_CODE = r"""
import sys
import torch, torch.distributed as dist
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method="file://" + sys.argv[1], rank=0,
                        world_size=1)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.models import attention as A, shardctx
mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
cfg = get_config("qwen2-1.5b")
g = torch.Generator().manual_seed(1)
whole, rows, parts = ([Replicate(), Replicate()], [Shard(0), Replicate()],
                      [Shard(0), Shard(1)])
B, T = 8, 512


def put(x, pl):
    return distribute_tensor(x, mesh, pl)


for cross in (False, True):
    ap = {k: v.cuda() for k, v in A.init_attn(g, cfg, torch.float32, "cpu",
                                              cross=cross).items()}
    dp = {k: put(v, whole) for k, v in ap.items()}
    k, v = (torch.randn((B, T, cfg.n_kv_heads, cfg.head_dim),
                        generator=g).cuda() for _ in range(2))
    lens = torch.tensor([0, 1, 63, 64, 200, 255, 256, 511], dtype=torch.int32,
                        device="cuda")
    pc = A.KVCache(k.clone(), v.clone(), lens.clone())
    sc = A.KVCache(put(k, parts), put(v, parts), put(lens, rows))
    for step in range(3):
        x = torch.randn((B, 1, cfg.d_model), generator=g).cuda()
        n = da_ops.counter.launches
        with torch.no_grad(), shardctx.mixed():
            if cross:
                so = A.cross_attention(dp, cfg, put(x, rows),
                                       (sc.k, sc.v))
            else:
                so, sc = A.decode_self_attention(dp, cfg, put(x, rows), sc)
        launched = da_ops.counter.launches - n
        with torch.no_grad():
            if cross:
                po = A.cross_attention(ap, cfg, x, (pc.k, pc.v))
            else:
                po, pc = A.decode_self_attention(ap, cfg, x, pc)
        err = float((so.full_tensor() - po).abs().max())
        print("CASE", cross, step, launched, err, flush=True)
        assert launched == 1, launched
        assert err <= 1e-5 * float(po.abs().max()), err
    if not cross:
        assert torch.equal(sc.k.full_tensor(), pc.k)
        assert torch.equal(sc.length.full_tensor(), pc.length)
print("OK", flush=True)
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_cuda_sharded_decode_launches_the_kernel(tmp_path):
    """On the card, a sharded cache (rows over "data", positions over
    "model", a one-rank NCCL mesh) decodes through the decode-attention
    kernel, one launch a call, self- and cross-attention at Qwen2-1.5B's
    width, equal to the plain layer; the rows written in place equal the
    plain cache's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    p = subprocess.run([sys.executable, "-c", CUDA_DECODE_CODE,
                        str(tmp_path / "store")], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0 and "OK" in p.stdout, \
        (p.stdout + p.stderr)[-4000:]
