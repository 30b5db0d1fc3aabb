"""GROUP BY served as lane blocks by the port's ``LanePool`` and
``AQPSession``, against the JAX reference and against the port's own
closed-loop runs, at the size of test_serve_groupby.py.

* a pool block against the reference pool's block (integers exact, theta
  rtol 1e-5, error rtol 1e-3: the reference's grouped tolerance) and against
  the port's ``fused_grouped`` under the pool's sample key (bit for bit);
* solo and grouped traffic in one pool, in the same scheduling rounds, each
  bit-equal to its closed-loop run;
* the session's routing of grouped requests and its per-group response;
* rotation of the sample key held off while a block is resident.

Solo requests here are held against the port's own solo run rather than the
reference: with 8 groups the error model's f32 normal equations amplify the
packages' ~1e-6 differences in the error profile to ~1e-3 in its
coefficients, which can move a predicted size by a few rows.
"""
import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.aqp.query import Query as JQuery, Request as JRequest
from repro.core.sampling import GroupedData as JGroupedData
from repro.serve import (AQPSession as JSession, LanePool as JPool,
                         Planner as JPlanner, Route as JRoute)
from repro_torch.aqp.query import Query, Request
from repro_torch.core import fused as tf
from repro_torch.core import keys as keylib
from repro_torch.core.sampling import GroupedData, stratified_slot_tables
from repro_torch.serve import (AQPSession, GroupPoolResponse, LanePool,
                               Planner, PoolResponse, Route)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per test worker keeps
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


G = 8
SPEC = dict(B=64, n_min=200, n_max=400, max_iters=16, n_cap=1 << 12)
POOL_KW = dict(l=6, ext_cap=1 << 9, **SPEC)
EPS = 0.1
SESSION_KW = dict(seed=0, reshuffle_every=1000, **SPEC)


def _tables(seed=7):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1200, 6000, size=G)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    vals = np.empty((int(offsets[-1]), 1), np.float32)
    for g in range(G):
        vals[offsets[g]:offsets[g + 1], 0] = rng.normal(
            rng.normal(5.0, 2.0), rng.uniform(0.5, 1.5), size=sizes[g])
    return vals, offsets


@pytest.fixture(scope="module")
def data():
    vals, offsets = _tables()
    return (JGroupedData(vals, offsets),
            GroupedData(torch.from_numpy(vals), offsets, device="cpu"))


GKEY = np.asarray(jax.random.PRNGKey(99))
SKEY = np.asarray(jax.random.PRNGKey(3))
SOLO = ("avg", 0.5)


@pytest.fixture(scope="module")
def pools(data):
    """One grouped and one solo request through a pool of each package."""
    jd, td = data
    skey = jax.random.PRNGKey(42)
    jp = JPool(jd, lanes=4, seed=0, sample_key=skey, **POOL_KW)
    tp = LanePool(td, lanes=4, seed=0, sample_key=np.asarray(skey), **POOL_KW)
    jq = jp.submit_group(JQuery(func="avg", epsilon=EPS, group_by=True),
                         key=GKEY)
    tq = tp.submit_group(Query(func="avg", epsilon=EPS, group_by=True),
                         key=GKEY)
    js_ = jp.submit(JQuery(func=SOLO[0], epsilon=SOLO[1]), key=SKEY)
    ts_ = tp.submit(Query(func=SOLO[0], epsilon=SOLO[1]), key=SKEY)
    per_round = []                    # dispatches of each scheduling round
    while tp.busy_lanes or tp.busy_blocks or tp.queue_depth:
        d0 = tp.dispatches
        tp.tick()
        per_round.append(tp.dispatches - d0)
    rt = {r.qid: r for r in tp.drain()}
    rj = {r.qid: r for r in jp.drain()}
    return dict(tp=tp, block=rt[tq], jblock=rj[jq], solo=rt[ts_],
                per_round=per_round)


def test_pool_block_matches_reference_pool(pools):
    a, b = pools["block"], pools["jblock"]
    assert isinstance(a, GroupPoolResponse) and a.group_by
    assert a.theta.shape == a.error.shape == a.n.shape == (G,)
    assert a.beta.shape == (G, 2)
    assert np.array_equal(a.n, np.asarray(b.n))
    assert np.array_equal(a.iterations, np.asarray(b.iterations))
    assert np.array_equal(a.group_success, np.asarray(b.group_success))
    assert a.success == b.success and a.failed == b.failed
    assert a.rows_sampled == b.rows_sampled
    assert_allclose(a.theta, np.asarray(b.theta), rtol=1e-5)
    assert_allclose(a.error, np.asarray(b.error), rtol=1e-3)


def test_pool_block_equals_fused_grouped_bit_exact(data, pools):
    """The block under the pool's sample key equals the closed-loop
    ``fused_grouped`` run with the pool's statics in every bit."""
    td, tp, a = data[1], pools["tp"], pools["block"]
    ref = tf.fused_grouped(
        td.values, td.offsets, np.ones(G), GKEY, EPS, 0.05,
        sample_key=tp._sample_key, est_name=None,
        est_fids=np.zeros(G, np.int32), **POOL_KW)
    assert a.success and bool(ref.success.all())
    assert np.array_equal(a.n, ref.n.numpy())
    assert np.array_equal(a.iterations, ref.iterations.numpy())
    assert np.array_equal(a.error, ref.error.numpy())
    assert np.array_equal(a.theta, ref.theta[:, 0].numpy())
    assert np.array_equal(a.beta, ref.beta.numpy())
    assert a.rows_sampled == int(ref.rows_sampled.sum())


def test_pool_mixes_solo_and_grouped_traffic(data, pools):
    """The solo lane and the block ride the same rounds, and each answers
    as if alone."""
    td, tp, solo = data[1], pools["tp"], pools["solo"]
    assert isinstance(solo, PoolResponse) and solo.success
    assert pools["per_round"][0] == 2     # one tier + the block, one round
    want = tf.fused_l2miss(td.values, td.offsets, np.ones(G, np.float32),
                           SKEY, SOLO[1], 0.05, sample_key=tp._sample_key,
                           est_name=SOLO[0], **POOL_KW)
    assert np.array_equal(solo.n, want.n.numpy())
    assert solo.error == float(want.error)
    assert np.array_equal(solo.theta, want.theta.numpy())
    st = tp.stats()
    assert st["submitted"] == st["retired"] == 2
    assert st["grouped_submitted"] == st["grouped_retired"] == 1
    assert st["busy_blocks"] == 0
    assert st["block_ticks"] == pools["block"].ticks_in_block > 0
    assert st["dispatches"] > st["ticks"]


def test_pool_holds_rotation_while_a_block_is_resident(data):
    td = data[1]
    pool = LanePool(td, lanes=2, seed=0, **POOL_KW)
    pool.submit_group(Query(func="avg", epsilon=EPS, group_by=True),
                      key=GKEY)
    pool.tick()
    assert pool.busy_blocks == 1
    with pytest.raises(RuntimeError):
        pool.set_sample_key(keylib.prng_key(1))
    assert pool.request_sample_key(keylib.prng_key(1)) is False
    assert pool.stats()["pending_rotation"]
    (res,) = pool.drain()
    assert res.success and pool.busy_blocks == 0
    pool.tick()                       # the idle point applies the rotation
    assert pool.sample_epochs == 1
    assert np.array_equal(pool._sample_key, keylib.prng_key(1))
    assert torch.equal(pool._grouped_tables(), stratified_slot_tables(
        keylib.prng_key(1), td.offsets, SPEC["n_cap"], device="cpu"))


def test_pool_refuses_what_blocks_cannot_serve(data):
    pool = LanePool(data[1], lanes=2, **POOL_KW)
    # A warm block is accepted; its rows come both or neither.
    pool.submit_group(Query(func="avg", epsilon=EPS, group_by=True),
                      warm_n0=np.full(G, 400), warm_beta=np.ones((G, 2)))
    assert pool.busy_blocks == 1 and pool.warm_spliced == 1
    with pytest.raises(ValueError):
        pool.submit_group(Query(func="avg", epsilon=EPS, group_by=True),
                          warm_beta=np.ones((G, 2)))
    with pytest.raises(ValueError):
        pool.submit_group(Query(func="median", epsilon=EPS, group_by=True))
    assert not pool.supports_grouped(Query(func="avg", epsilon=EPS,
                                           metric="linf", group_by=True))
    assert pool.supports_grouped(Query(func="std", epsilon=EPS,
                                       group_by=True))


def test_session_routes_grouped_requests(data):
    """Grouped POOL requests ride pool blocks beside a solo lane; each
    response carries per-group errors and verdicts, its error the max over
    groups and its success their conjunction."""
    jd, td = data
    plan = dict(pool_lanes=2, pool_ticks_per_sync=1)
    js = JSession(jd, planner=JPlanner(mode=JRoute.POOL, **plan),
                  **SESSION_KW)
    ts = AQPSession(td, planner=Planner(mode=Route.POOL, **plan),
                    **SESSION_KW)
    reqs = [dict(func="avg", epsilon=EPS, group_by=True),
            dict(func="sum", epsilon=600.0, group_by=True),
            dict(func="std", epsilon=EPS, group_by=True)]
    for r in reqs:
        js.submit(JRequest(query=JQuery(**r)))
        ts.submit(Request(query=Query(**r)))
    ts.submit(Request(query=Query(func="avg", epsilon=0.2)), key=SKEY)
    rj, rt = js.drain(), ts.drain()
    assert [r.route for r in rt] == [Route.POOL] * 4
    for r, a, b in zip(reqs, rt, rj):
        assert a.group_by and b.group_by
        assert a.group_error.shape == a.group_success.shape == (G,)
        assert a.error == float(np.max(a.group_error))
        assert a.success == bool(a.group_success.all())
        assert np.array_equal(np.asarray(a.n), np.asarray(b.n))
        assert np.array_equal(a.group_success, np.asarray(b.group_success))
        assert a.rows_sampled == b.rows_sampled
        # The std finish takes sqrt(E[x^2] - mean^2), where mean^2 is ~25x
        # the variance on this table: it loses a digit to f32 sum order.
        rtol = 1e-4 if r["func"] == "std" else 1e-5
        assert_allclose(np.asarray(a.theta), np.asarray(b.theta), rtol=rtol)
        assert_allclose(a.group_error, np.asarray(b.group_error), rtol=1e-3)
    solo = rt[3]
    assert not solo.group_by and solo.group_error is None
    want = tf.fused_l2miss(td.values, td.offsets, np.ones(G, np.float32),
                           SKEY, 0.2, 0.05, sample_key=ts._sample_key,
                           est_name="avg", l=min(G + 2, 12), **SPEC)
    assert solo.success and np.array_equal(solo.n, want.n.numpy())
    assert solo.error == float(want.error)
    st = ts.stats()
    assert st["pool"]["grouped_retired"] == 3
    assert ts.rows_touched == sum(r.rows_sampled for r in rt)


def test_session_grouped_host_shapes_wait_for_the_host_route(data):
    """A grouped clause no block can serve routes HOST; the engine's grouped
    path verifies per-group l2 only (as the reference's), so a linf clause
    raises there and the request stays in flight."""
    ts = AQPSession(data[1], **SESSION_KW)
    ts.submit(Request(query=Query(func="avg", epsilon=EPS, metric="linf",
                                  group_by=True)))
    with pytest.raises(ValueError):
        ts.pump()
    assert ts.in_flight == 1
