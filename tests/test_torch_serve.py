"""The port's serving path against the JAX reference: ``LanePool`` and
``AQPSession`` (forced POOL, then auto with a LOOP singleton) in both
packages on the same tables, seeds and requests, over the six fusable funcs
(proportion and count on 0/1 data); and, inside the port, a pool lane equal
bit for bit to its solo ``fused_l2miss`` run.

Tolerances as in test_torch_fused.py: integers exact, theta rtol 1e-5, error
rtol 1e-4."""
import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.aqp.query import Query as JQuery, Request as JRequest
from repro.core.sampling import GroupedData as JGroupedData
from repro.data import make_grouped as j_make_grouped
from repro.serve import (AQPSession as JSession, LanePool as JPool,
                         Planner as JPlanner, Route as JRoute)
from repro_torch.aqp.query import Query, Request
from repro_torch.core import estimators
from repro_torch.core.fused import fused_l2miss
from repro_torch.core.sampling import GroupedData
from repro_torch.data import make_grouped
from repro_torch.serve import AQPSession, LanePool, Planner, Route


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per test worker keeps
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPEC = dict(B=100, n_min=300, n_max=600, l=6, max_iters=16, n_cap=1 << 13,
            ext_cap=1 << 10)


SESSION_KW = dict(B=100, n_min=300, n_max=600, max_iters=16, n_cap=1 << 13,
                  seed=0, reshuffle_every=1000)


def _binary_groups():
    rng = np.random.default_rng(2)
    return [(rng.uniform(size=60_000) < p).astype(np.float32)
            for p in (0.3, 0.6)]


@pytest.fixture(scope="module")
def cont():
    args = (["normal", "exp"], 60_000)
    kw = dict(seed=1, biases=[5.0, 3.0])
    return (j_make_grouped(*args, **kw),
            make_grouped(*args, **kw, device="cpu"))


@pytest.fixture(scope="module")
def binary():
    g = _binary_groups()
    return (JGroupedData.from_group_arrays(g),
            GroupedData.from_group_arrays(g, device="cpu"))


def _assert_answer(rt, rj):
    assert np.array_equal(np.asarray(rt.n), np.asarray(rj.n))
    assert rt.rows_sampled == rj.rows_sampled
    assert rt.success == rj.success
    assert_allclose(np.asarray(rt.theta), np.asarray(rj.theta), rtol=1e-5)
    assert_allclose(rt.error, rj.error, rtol=1e-4)


def _run_pools(pair, workload, lanes=4):
    jd, td = pair
    skey = jax.random.PRNGKey(42)
    keys = jax.random.split(jax.random.PRNGKey(11), len(workload))
    jp = JPool(jd, lanes=lanes, **SPEC, sample_key=skey, seed=5)
    tp = LanePool(td, lanes=lanes, **SPEC, sample_key=np.asarray(skey),
                  seed=5)
    for i, (f, e) in enumerate(workload):
        jp.submit(JQuery(func=f, epsilon=e), key=keys[i])
        tp.submit(Query(func=f, epsilon=e), key=np.asarray(keys[i]))
    return jp.drain(), tp.drain(), tp


def test_pool_matches_reference_moment_funcs(cont):
    scale = float(cont[1].scale.max())
    workload = [("avg", 0.1), ("var", 0.2), ("std", 0.12),
                ("sum", 0.15 * scale), ("avg", 0.06)]
    rj, rt, pool = _run_pools(cont, workload)
    assert len(rt) == len(workload)
    for a, b in zip(rt, rj):
        assert a.qid == b.qid and a.func == b.func
        assert a.lane == b.lane and a.iterations == b.iterations
        _assert_answer(a, b)
    st = pool.stats()
    assert st["submitted"] == st["retired"] == len(workload)
    assert 0.0 < st["lane_occupancy"] <= 1.0


def test_pool_matches_reference_on_binary_data(binary):
    n = float(binary[1].scale.max())
    workload = [("proportion", 0.02), ("count", 0.02 * n), ("avg", 0.03),
                ("var", 0.01)]
    rj, rt, _ = _run_pools(binary, workload)
    for a, b in zip(rt, rj):
        _assert_answer(a, b)
        assert a.success


def test_session_pool_then_loop_matches_reference(cont):
    jd, td = cont
    specs = [("avg", 0.06), ("var", 0.3), ("std", 0.25)]
    keys = jax.random.split(jax.random.PRNGKey(3), len(specs))
    js = JSession(jd, planner=JPlanner(mode=JRoute.POOL, pool_lanes=2,
                                       pool_ticks_per_sync=1), **SESSION_KW)
    ts = AQPSession(td, planner=Planner(mode=Route.POOL, pool_lanes=2,
                                        pool_ticks_per_sync=1), **SESSION_KW)
    for (f, e), k in zip(specs, keys):
        js.submit(JRequest(query=JQuery(func=f, epsilon=e)), key=k)
        ts.submit(Request(query=Query(func=f, epsilon=e)),
                  key=np.asarray(k))
    rj, rt = js.drain(), ts.drain()
    assert [r.route for r in rt] == [Route.POOL] * 3
    for a, b in zip(rt, rj):
        _assert_answer(a, b)
    assert ts.rows_touched == sum(r.rows_sampled for r in rt)
    # Auto planner: a cold singleton takes the LOOP route (keys drawn from
    # the session key, so both packages must derive the same one).
    js = JSession(jd, **SESSION_KW)
    ts = AQPSession(td, **SESSION_KW)
    js.submit(JRequest(query=JQuery(func="sum", epsilon=0.1 * 60_000)))
    ts.submit(Request(query=Query(func="sum", epsilon=0.1 * 60_000)))
    (a,), (b,) = ts.drain(), js.drain()
    assert a.route is Route.LOOP and b.route is JRoute.LOOP
    _assert_answer(a, b)
    assert ts.stats()["fused_dispatches"] == 1


def _solo(td, func, key, eps, skey, l):
    scale = (np.asarray(td.scale, np.float32)
             if estimators.get(func).needs_population_scale
             else np.ones(td.num_groups, np.float32))
    return fused_l2miss(td.values, td.offsets, scale, key, eps, 0.05,
                        sample_key=skey, **{**SPEC, "est_name": func, "l": l})


def test_pool_lane_equals_solo_run_bit_exact(cont):
    """A straggler holds its lane while the neighbour retires and refills;
    every answer equals its solo run in every bit."""
    td = cont[1]
    skey = np.asarray(jax.random.PRNGKey(42))
    pool = LanePool(td, lanes=2, tiers=1, **SPEC, sample_key=skey, seed=5)
    specs = [("avg", 0.06), ("var", 0.25), ("avg", 0.25), ("std", 0.3)]
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(11), len(specs)))
    qids = [pool.submit(Query(func=f, epsilon=e), key=keys[i])
            for i, (f, e) in enumerate(specs)]
    res = {r.qid: r for r in pool.drain()}
    assert res[qids[0]].iterations > max(res[q].iterations for q in qids[1:])
    for i, (f, e) in enumerate(specs):
        solo = _solo(td, f, keys[i], e, skey, pool._spec["l"])
        r = res[qids[i]]
        assert r.success and bool(solo.success)
        assert np.array_equal(r.n, solo.n.numpy())
        assert r.iterations == int(solo.iterations)
        assert r.rows_sampled == int(solo.rows_sampled)
        assert r.error == float(solo.error)
        assert np.array_equal(r.theta, solo.theta.numpy())
        assert np.array_equal(r.beta, solo.beta.numpy())


def test_later_slices_raise(cont):
    td = cont[1]
    with pytest.raises(NotImplementedError):
        LanePool(td, degrade=True)
    with pytest.raises(NotImplementedError):
        LanePool(td, data_shards=2)
    with pytest.raises(NotImplementedError):
        AQPSession(td, warm_cache=True)
    pool = LanePool(td, lanes=2, **SPEC)
    with pytest.raises(NotImplementedError):
        pool.submit(Query(func="avg", epsilon=0.1), warm_n0=np.ones(2),
                    warm_beta=np.ones(3))
    with pytest.raises(NotImplementedError):
        pool.submit_group(Query(func="avg", epsilon=0.1, group_by=True))
    with pytest.raises(ValueError):
        pool.submit(Query(func="median", epsilon=0.1))
    sess = AQPSession(td, **SESSION_KW)
    sess.submit(Request(query=Query(func="median", epsilon=0.1)))
    with pytest.raises(NotImplementedError):
        sess.pump()
    assert sess.in_flight == 1        # re-queued, not lost
    with pytest.raises(TypeError):
        sess.submit(Query(func="avg", epsilon=0.1))
