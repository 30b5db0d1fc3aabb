"""The port's data mesh: four gloo ranks, each a subprocess, against the
single-device run of the same shard layout.

The reference's mesh test (tests/test_shard_parity.py
``test_mesh_pool_bit_equal_to_solo_pool``) needs a multi-device host mesh
and skips in one-device runs; here the mesh is four ``torch.distributed``
processes on the CPU, so it runs.  One launch of four ranks (``OMP_NUM_THREADS
=1``, a ``file://`` store, 120 s limit) drives every scenario; each rank
writes its answers to an ``.npz`` and rank 0 adds the ``mesh=False`` runs,
which the tests below read:

* the fold: ``all_gather_fold`` of partials of mixed magnitude equals the
  sequential fold ``((p0 + p1) + p2) + p3`` bit for bit (an all-reduce need
  not: its order is the backend's);
* a mesh pool drains bit-equal to the ``mesh=False`` pool of the same layout
  (refills mid-drain, one and two ticks a sync), with exactly one collective
  a tick;
* a sharded ``AQPSession`` over the mesh answers as the ``mesh=False``
  session does, bit for bit;
* an SLO burst (degrade, weighted fair queueing) with decisive deadlines
  takes the same decisions on every rank, from rank 0's clock.

On a card (``-m cuda``; this file imports no JAX) the sharded step's
prefix-rung path through the Poisson-bootstrap kernel equals the CPU's
plain windowed path, and a sharded run on the card equals the CPU's.

S = 4: at S = 2 no fold order can differ, f32 addition being commutative.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.mesh import DataMesh, make_data_mesh, shard_dataset

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4

RANK_CODE = r"""
import sys, time
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
from repro_torch.aqp.query import Query, Request
from repro_torch.core import keys
from repro_torch.core.mesh import make_data_mesh
from repro_torch.data import make_grouped
from repro_torch.serve import AQPSession, LanePool, Planner, Route

res = {}
mesh = make_data_mesh(world, device="cpu")

# -- the fold: mixed magnitudes, every rank regenerates every partial -------
def partial(r):
    g = np.random.default_rng(100 + r)
    return (g.standard_normal(4096) * 10.0 ** g.integers(-6, 7, 4096)
            ).astype(np.float32)
got = mesh.all_gather_fold(torch.from_numpy(partial(rank))).numpy()
seq = torch.from_numpy(partial(0))
for r in range(1, world):
    seq = seq + torch.from_numpy(partial(r))
res["fold_equal"] = got.tobytes() == seq.numpy().tobytes()
red = torch.from_numpy(partial(rank))
dist.all_reduce(red)
res["allreduce_diff"] = int((red != seq).sum())
try:
    make_data_mesh(world - 1)
    res["size_check"] = False
except ValueError:
    res["size_check"] = True

SPEC = dict(B=60, n_min=100, n_max=256, max_iters=8, n_cap=1 << 10)
td = make_grouped(["normal", "exp"], 12_000, seed=3, biases=[4.0, 2.0],
                  device="cpu")
try:
    LanePool(td, data_shards=2, mesh=mesh, **SPEC)
    res["pool_size_check"] = False
except ValueError:
    res["pool_size_check"] = True
specs = [("avg", 0.25), ("var", 0.3), ("avg", 0.12), ("std", 0.12),
         ("avg", 0.1), ("sum", 1800.0), ("avg", 0.25), ("std", 0.2)]
qkeys = keys.split(keys.prng_key(6), len(specs))

def answers(rs, tag):
    res[tag + "_n"] = np.stack([np.ravel(r.n) for r in rs])
    res[tag + "_it"] = np.asarray([getattr(r, "iterations", -1) for r in rs])
    res[tag + "_ok"] = np.asarray([r.success for r in rs])
    res[tag + "_err"] = np.asarray([r.error for r in rs], np.float32)
    res[tag + "_theta"] = np.stack([np.ravel(r.theta) for r in rs]
                                   ).astype(np.float32)

for tag, kw in (("flat", dict(lanes=2 * world, tiers=1)),
                ("refill", dict(lanes=4, tiers=2, ticks_per_sync=2))):
    for m in ((mesh, False) if rank == 0 else (mesh,)):
        g0 = mesh.gathers
        pool = LanePool(td, data_shards=world, mesh=m, seed=0,
                        sample_key=keys.prng_key(9), **kw, **SPEC)
        qids = [pool.submit(Query(func=f, epsilon=e), key=qkeys[i])
                for i, (f, e) in enumerate(specs)]
        out_ = {r.qid: r for r in pool.drain()}
        answers([out_[q] for q in qids], tag + ("_mesh" if m else "_solo"))
        if m:
            res[tag + "_gathers"] = mesh.gathers - g0
            res[tag + "_ticks"] = pool.dispatches * pool.ticks_per_sync
            res[tag + "_shard_rows"] = np.asarray(pool.stats()["shard_rows"])

# -- a sharded session, forced POOL --------------------------------------
for m in ((mesh, False) if rank == 0 else (mesh,)):
    sess = AQPSession(td, data_shards=world, mesh=m, seed=0,
                      reshuffle_every=1000,
                      planner=Planner(mode=Route.POOL, pool_lanes=4,
                                      data_shards=world), **SPEC)
    for f, e in specs:
        sess.submit(Request(query=Query(func=f, epsilon=e)))
    answers(sess.drain(), "sess_mesh" if m else "sess_solo")

# -- an SLO burst: decisive deadlines, two tenants ---------------------------
b0 = mesh.broadcasts
sess = AQPSession(td, data_shards=world, mesh=mesh, seed=0,
                  reshuffle_every=1000, degrade=True, wfq=True,
                  tenant_weights={"dash": 3.0, "batch": 1.0},
                  planner=Planner(mode=Route.POOL, pool_lanes=4,
                                  data_shards=world, slo_native=True), **SPEC)
for i, (f, e) in enumerate(specs * 2):
    sess.submit(Request(query=Query(func=f, epsilon=e),
                        deadline_s=1e-9 if i % 3 == 0 else 1e6,
                        tenant="dash" if i % 2 else "batch", priority=i % 2))
rs = sess.drain()
answers(rs, "slo")
res["slo_shed"] = np.asarray([r.shed for r in rs])
res["slo_degraded"] = np.asarray([r.degraded for r in rs])
res["slo_delivered"] = np.asarray([r.delivered_epsilon for r in rs])
res["slo_broadcasts"] = mesh.broadcasts - b0
np.savez(out + str(rank) + ".npz", **res)
dist.barrier()
dist.destroy_process_group()
"""


def run_ranks(code: str, tmp: Path, world: int = WORLD) -> list:
    """Launch ``world`` ranks of ``code`` (argv: rank, world, store, out
    prefix) as subprocesses; return each rank's ``.npz``."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(ROOT / "src")}
    env.pop("CUDA_VISIBLE_DEVICES", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), str(tmp / "store"),
         str(tmp / "rank")], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}: {errs[r][-3000:]}"
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(RANK_CODE, tmp_path_factory.mktemp("mesh"))


def _bits(x) -> bytes:
    return np.ascontiguousarray(x).tobytes()


def test_all_gather_fold_is_the_sequential_fold(ranks):
    for r in ranks:
        assert bool(r["fold_equal"])
        assert bool(r["size_check"]) and bool(r["pool_size_check"])
    # The all-reduce's answer is the backend's order; it is recorded only.
    assert ranks[0]["allreduce_diff"] >= 0


@pytest.mark.parametrize("tag", ["flat", "refill"])
def test_mesh_pool_bit_equal_to_mesh_false_pool(ranks, tag):
    r0 = ranks[0]
    for f in ("n", "it", "ok", "err", "theta"):
        assert _bits(r0[f"{tag}_mesh_{f}"]) == _bits(r0[f"{tag}_solo_{f}"]), f
        for r in ranks[1:]:
            assert _bits(r[f"{tag}_mesh_{f}"]) == _bits(r0[f"{tag}_mesh_{f}"])
    assert r0[f"{tag}_mesh_ok"].sum() >= 6
    assert r0[f"{tag}_mesh_it"].max() > 1
    for r in ranks:
        assert np.array_equal(r[f"{tag}_shard_rows"], r0[f"{tag}_shard_rows"])


@pytest.mark.parametrize("tag", ["flat", "refill"])
def test_one_collective_a_tick(ranks, tag):
    for r in ranks:
        assert int(r[f"{tag}_gathers"]) == int(r[f"{tag}_ticks"]) > 0


def test_mesh_session_bit_equal_to_mesh_false_session(ranks):
    r0 = ranks[0]
    for f in ("n", "it", "ok", "err", "theta"):
        assert _bits(r0[f"sess_mesh_{f}"]) == _bits(r0[f"sess_solo_{f}"]), f
        for r in ranks[1:]:
            assert _bits(r[f"sess_mesh_{f}"]) == _bits(r0[f"sess_mesh_{f}"])
    assert r0["sess_mesh_ok"].sum() >= 5


def test_slo_burst_in_lockstep(ranks):
    """Every rank sheds, degrades and answers alike; the shed ones are the
    blown deadlines, every successful answer meets its delivered bound, and
    the ranks read rank 0's clock (broadcasts) while degrade is armed."""
    r0 = ranks[0]
    for r in ranks[1:]:
        for f in ("shed", "degraded", "delivered", "n", "err", "theta"):
            assert _bits(r[f"slo_{f}"]) == _bits(r0[f"slo_{f}"]), f
        assert int(r["slo_broadcasts"]) == int(r0["slo_broadcasts"])
    shed = r0["slo_shed"]
    assert np.array_equal(shed, np.arange(len(shed)) % 3 == 0)
    assert not r0["slo_degraded"][~shed].any()
    met = r0["slo_ok"] | shed
    assert met.sum() >= len(shed) - 3
    assert np.all(r0["slo_err"][met] <= r0["slo_delivered"][met] * (1 + 1e-6))
    assert int(r0["slo_broadcasts"]) > len(shed)


def test_mesh_needs_an_initialised_group():
    """No process group, no mesh: the port never falls back to one
    process."""
    with pytest.raises(ValueError):
        DataMesh(device="cpu")
    with pytest.raises(ValueError):
        make_data_mesh(4, device="cpu")


def test_shard_dataset_blocks_pad_with_invalid_rows():
    gid = np.arange(10) % 3
    x = np.arange(10, dtype=np.float32)
    g, v = shard_dataset(None, gid, x, device="cpu")
    assert np.array_equal(g.numpy(), gid) and np.array_equal(v.numpy(), x)

    class Rank:                      # the fields shard_dataset reads
        size, device = 4, torch.device("cpu")

    blocks = []
    for r in range(4):
        Rank.rank = r
        blocks.append(shard_dataset(Rank, gid, x))
    g_all = np.concatenate([b[0].numpy() for b in blocks])
    x_all = np.concatenate([b[1].numpy() for b in blocks])
    assert len(g_all) == 12 and np.array_equal(g_all[10:], [-1, -1])
    assert np.array_equal(g_all[:10], gid) and np.array_equal(x_all[:10], x)
    assert all(b[0].dtype == torch.int32 for b in blocks)


@pytest.mark.cuda
def test_cuda_sharded_path_equals_plain():
    """On the card: the prefix-rung path through the Poisson-bootstrap
    kernel equals the plain windowed path bit for bit, and a sharded solo run
    on the card equals the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import bootstrap, keys
    from repro_torch.core.fused import fused_l2miss
    from repro_torch.data import make_grouped

    rng = np.random.default_rng(4)
    q, m, cap = 9, 3, 1024
    vals = torch.from_numpy(rng.normal(size=(q, m, cap)).astype(np.float32))
    lo = torch.from_numpy(rng.integers(300, 600, size=(q, m)).astype(np.int32))
    hi = torch.clamp(lo + torch.from_numpy(
        rng.integers(1, 400, size=(q, m)).astype(np.int32)), max=cap)
    seeds = torch.from_numpy(rng.integers(0, 2**32, size=(q, m)))
    act = torch.from_numpy(np.arange(q) % 3 != 1)
    M, Mp = bootstrap.windowed_lane_moment_sums(vals, lo, hi, seeds, 24,
                                                (512, cap), lane_active=act)
    M2, Mp2 = bootstrap.prefix_lane_moment_sums(
        vals.cuda(), lo.cuda(), hi.cuda(), seeds.cuda(), 24,
        int(hi[act].max()), lane_active=act.cuda(), use_kernel=True)
    assert torch.equal(M, M2.cpu()) and torch.equal(Mp, Mp2.cpu())
    a, b = (fused_l2miss(
        d.values, d.offsets, np.ones(2, np.float32), keys.prng_key(3), 0.06,
        0.05, sample_key=keys.prng_key(9), est_name="avg", data_shards=4, l=4,
        B=60, n_min=100, n_max=256, max_iters=8, n_cap=1 << 12)
        for d in (make_grouped(["normal", "exp"], 12_000, seed=3,
                               biases=[4.0, 2.0], device=dev)
                  for dev in ("cuda", "cpu")))
    for f in ("n", "iterations", "rows_sampled", "error", "theta"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
