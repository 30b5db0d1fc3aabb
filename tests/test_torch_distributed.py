"""``repro_torch.aqp.distributed`` against the reference's
``repro.aqp.distributed`` and numpy.

* One shard (``mesh=None``) against the reference's one-device mesh on the
  same rows and seeds: the exact GROUP BY (counts, min and max equal, sums
  within f32 order) and the sharded bootstrap (the same Bernoulli sample and
  Poisson weights; error and estimates within f32 order).
* tests/test_aqp_serve_integration.py's ``test_sharded_aqp_subprocess`` on
  four gloo ranks (subprocesses): group stats against numpy, the one-shard
  values and the reference's one-device values, the bootstrap's estimates
  near the group means, every rank holding the same answer.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.aqp import distributed as JD
from repro_torch.aqp import distributed as D
from test_torch_mesh import run_ranks

N, M = 40_000, 4


def _table():
    rng = np.random.default_rng(0)
    gid = rng.integers(0, M, N)
    x = rng.standard_normal(N).astype(np.float32) + gid
    return gid, x


@pytest.fixture(scope="module")
def one_shard():
    gid, x = _table()
    mesh = JD.make_data_mesh(1)
    jg, jx = JD.shard_dataset(mesh, gid, x)
    tg, tx = D.shard_dataset(None, gid, x, device="cpu")
    return gid, x, mesh, jg, jx, tg, tx


def test_group_stats_one_shard_match_reference_and_numpy(one_shard):
    gid, x, mesh, jg, jx, tg, tx = one_shard
    ref = JD.sharded_group_stats(mesh, jg, jx, M)
    got = D.sharded_group_stats(None, tg, tx, M)
    for k in ("count", "min", "max"):
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    for k in ("sum", "sumsq"):
        assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5)
    for g in range(M):
        xg = x[gid == g].astype(np.float64)
        assert got["count"][g] == len(xg)
        assert_allclose(float(got["sum"][g]), xg.sum(), rtol=1e-4)
        assert_allclose(float(got["sumsq"][g]), (xg * xg).sum(), rtol=1e-4)
        assert float(got["min"][g]) == np.float32(xg.min())
        assert float(got["max"][g]) == np.float32(xg.max())


def test_group_stats_mask_padding_rows():
    """Padding rows (gid -1) count nowhere, whatever their value; an empty
    group reads the reference's sentinels."""
    gid = np.asarray([0, 0, 2, -1, -1], np.int32)
    x = np.asarray([1.0, 3.0, -2.0, 1e30, -1e30], np.float32)
    got = D.sharded_group_stats(None, torch.from_numpy(gid),
                                torch.from_numpy(x), 3)
    assert got["count"].tolist() == [2.0, 0.0, 1.0]
    assert got["sum"].tolist() == [4.0, 0.0, -2.0]
    assert got["min"][1] == np.float32(3e38) and got["max"][1] == \
        np.float32(-3e38)


@pytest.mark.parametrize("est,B,seed", [("avg", 100, 42), ("var", 64, 7),
                                        ("sum", 50, 3)])
def test_bootstrap_one_shard_matches_reference(one_shard, est, B, seed):
    gid, x, mesh, jg, jx, tg, tx = one_shard
    rate = np.asarray([0.2, 0.1, 0.3, 0.15], np.float32)
    e_j, th_j = JD.sharded_bootstrap_estimate(
        mesh, jg, jx, M, jnp.asarray(rate), seed, B=B, est_name=est,
        sample_seed=seed + 1)
    e_t, th_t = D.sharded_bootstrap_estimate(
        None, tg, tx, M, rate, seed, B=B, est_name=est, sample_seed=seed + 1)
    assert_allclose(th_t.numpy(), np.asarray(th_j), rtol=2e-5, atol=1e-5)
    assert_allclose(float(e_t), float(e_j), rtol=1e-4)


def test_bootstrap_sample_nests_and_rejects_non_moments(one_shard):
    """Under one sample seed a larger rate keeps a superset of rows (here:
    more of them), and a non-moment estimator raises, as in the
    reference."""
    gid, x, mesh, jg, jx, tg, tx = one_shard
    counts = []
    for r in (0.05, 0.1, 0.2):
        M_ = D._bootstrap_partials(tg, tx, M, torch.full((M,), r), 1, 99, 0,
                                   4)
        counts.append(M_[:, 0, 0].numpy())
    assert np.all(np.diff(np.stack(counts), axis=0) > 0)
    with pytest.raises(ValueError):
        D.sharded_bootstrap_estimate(None, tg, tx, M, np.full(M, 0.1), 1,
                                     est_name="median")


RANK_CODE = r"""
import sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
from repro_torch.aqp import distributed as D
rng = np.random.default_rng(0)
N, m = 40_000, 4
gid = rng.integers(0, m, N)
x = rng.standard_normal(N).astype(np.float32) + gid
mesh = D.make_data_mesh(world, device="cpu")
gs, xs = D.shard_dataset(mesh, gid, x)
st = D.sharded_group_stats(mesh, gs, xs, m)
e, theta = D.sharded_bootstrap_estimate(mesh, gs, xs, m,
                                        np.full(m, 0.2, np.float32), 42,
                                        B=100)
res = {k: v.numpy() for k, v in st.items()}
res.update(e=e.numpy(), theta=theta.numpy(), gathers=mesh.gathers,
           rows=len(gs))
np.savez(out + str(rank) + ".npz", **res)
dist.barrier()
dist.destroy_process_group()
"""


def test_sharded_aqp_four_ranks(tmp_path, one_shard):
    ranks = run_ranks(RANK_CODE, tmp_path)
    gid, x, mesh, jg, jx, _, _ = one_shard
    one = D.sharded_group_stats(None, *D.shard_dataset(None, gid, x,
                                                       device="cpu"), M)
    ref = JD.sharded_group_stats(mesh, jg, jx, M)
    mu = np.asarray([x[gid == g].mean() for g in range(M)])
    r0 = ranks[0]
    for r in ranks:
        for k in ("count", "sum", "sumsq", "min", "max", "e", "theta"):
            assert r[k].tobytes() == r0[k].tobytes(), k   # replicated answer
        assert int(r["gathers"]) == 2                      # one a call
        assert int(r["rows"]) == N // 4
    for g in range(M):
        assert r0["count"][g] == (gid == g).sum()
        assert_allclose(r0["sum"][g], x[gid == g].astype(np.float64).sum(),
                        rtol=1e-4)
    for k in ("count", "min", "max"):
        assert np.array_equal(r0[k], one[k].numpy()), k
        assert np.array_equal(r0[k], np.asarray(ref[k])), k
    for k in ("sum", "sumsq"):
        assert_allclose(r0[k], one[k].numpy(), rtol=1e-5)
        assert_allclose(r0[k], np.asarray(ref[k]), rtol=1e-5)
    assert_allclose(r0["theta"], mu, atol=0.1)
    assert 0 < float(r0["e"]) < 0.2
