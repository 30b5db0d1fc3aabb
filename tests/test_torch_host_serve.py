"""The port's serving front with the HOST route against the reference:
``AQPSession`` waves that mix pool lanes with host-engine requests (every
Listing-1 clause the pool cannot fuse), ``AQPService.answer`` batches that
reuse the resident sample store, and the accounting ``rows_touched`` =
store rows + fused rows.

Pool answers hold test_torch_serve.py's tolerances (integers exact, theta
rtol 1e-5, error rtol 1e-4).  A host answer's trajectory is held to the
reference's in tests/test_torch_host_engine.py; here a host answer either
has the reference's sizes (then theta rtol 1e-5, 1e-4 for var/std, and
error rtol 1e-4, 2e-3 for var/std) or, where an f32-noise straddle moved
a size, the same verdict with each error within its bound and the answers
within that bound of each other.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.aqp.query import Query as JQuery, Request as JRequest
from repro.core.sampling import GroupedData as JGroupedData
from repro.data import make_grouped as j_make_grouped
from repro.serve import AQPService as JService, AQPSession as JSession
from repro_torch.aqp import AQPEngine, Query, Request
from repro_torch.core.sampling import GroupedData
from repro_torch.data import make_grouped
from repro_torch.serve import AQPService, AQPSession, Route

SESSION_KW = dict(B=100, n_min=300, n_max=600, max_iters=16, n_cap=1 << 13,
                  seed=0, reshuffle_every=1000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cont():
    args = (["normal", "exp"], 60_000)
    kw = dict(seed=1, biases=[5.0, 3.0])
    return (j_make_grouped(*args, **kw),
            make_grouped(*args, **kw, device="cpu"))


def _regression_groups():
    """Two groups of [x, y] rows: y linear in x plus noise, and a 0/1 y."""
    rng = np.random.default_rng(5)
    out = []
    for slope in (1.5, -0.5):
        x = rng.normal(size=40_000)
        y = slope * x + 0.3 + 0.5 * rng.normal(size=x.shape)
        out.append(np.stack([x, y], 1).astype(np.float32))
    return out


WAVE = [
    dict(func="avg", epsilon=0.05),                      # POOL
    dict(func="var", epsilon=0.1),                       # POOL
    dict(func="median", epsilon=0.06),
    dict(func="avg", epsilon=0.06, metric="linf"),
    dict(func="sum", epsilon=6000.0, metric="l1"),
    dict(func="var", epsilon=0.1, metric="lp", lp=3.0),
    dict(func="std", epsilon=0.06, metric="diff"),
    dict(func="avg", metric="order"),
    dict(func="avg", epsilon_rel=0.01),
    dict(func="count", epsilon=1500.0, predicate=(">", ("col", 0), 4.5)),
    dict(func="avg", epsilon=0.06, group_by=True,
         predicate=(">", ("col", 0), 3.5)),            # HOST grouped
]


def _assert_host_answer(rt, rj, kw):
    assert rt.route is Route.HOST and rj.route.value == "host"
    assert rt.success == rj.success
    cancels = kw["func"] in ("var", "std")
    if np.array_equal(np.asarray(rt.n), np.asarray(rj.n)):
        assert_allclose(np.asarray(rt.theta, np.float64),
                        np.asarray(rj.theta, np.float64),
                        rtol=1e-4 if cancels else 1e-5)
        assert_allclose(rt.error, rj.error, rtol=2e-3 if cancels else 1e-4)
        return True
    bound = kw.get("epsilon")
    if bound is not None and rt.success:
        assert rt.error <= bound and rj.error <= bound
        gap = np.abs(np.ravel(rt.theta) - np.ravel(rj.theta)).max()
        assert gap <= bound
    return False


def test_session_wave_mixes_pool_and_host_like_the_reference(cont):
    jd, td = cont
    js, ts = JSession(jd, **SESSION_KW), AQPSession(td, **SESSION_KW)
    for kw in WAVE:
        js.submit(JRequest(query=JQuery(**kw)))
        ts.submit(Request(query=Query(**kw)))
    rj, rt = js.drain(), ts.drain()
    assert len(rt) == len(WAVE)
    same_sizes = True
    for a, b, kw in zip(rt, rj, WAVE):
        if kw.get("group_by") or kw.get("metric", "l2") != "l2" or \
                kw["func"] == "median" or "epsilon" not in kw or \
                "predicate" in kw:
            same_sizes &= _assert_host_answer(a, b, kw)
        else:
            assert a.route is Route.POOL and b.route.value == "pool"
            assert np.array_equal(a.n, np.asarray(b.n))
            assert a.rows_sampled == b.rows_sampled
            assert a.success == b.success
            assert_allclose(a.theta, np.asarray(b.theta), rtol=1e-5)
            assert_allclose(a.error, b.error, rtol=1e-4)
    st = ts.stats()
    assert st["rows_touched"] == st["store_rows"] + st["fused_rows"]
    assert ts.rows_touched == ts.store.rows_touched + ts._fused_rows
    assert st["store_rows"] > 0 and st["fused_rows"] > 0
    assert ts.fused_dispatches == js.fused_dispatches
    if same_sizes:
        assert ts.rows_touched == js.rows_touched


def test_service_batches_reuse_the_store_like_the_reference(cont):
    """A fused avg, a host median and a predicate count, answered twice:
    the second batch touches fewer new rows (the store's prefixes serve the
    host requests again), in both packages alike."""
    jd, td = cont
    qs = [dict(func="avg", epsilon=0.05), dict(func="median", epsilon=0.06),
          dict(func="count", epsilon=1500.0,
               predicate=(">", ("col", 0), 4.5))]
    jsv, tsv = JService(jd, **SESSION_KW), AQPService(td, **SESSION_KW)
    rows_t, rows_j = [], []
    for _ in range(2):
        ra = jsv.answer([JQuery(**kw) for kw in qs])
        rb = tsv.answer([Query(**kw) for kw in qs])
        rows_t.append(tsv.rows_touched)
        rows_j.append(jsv.rows_touched)
        assert [r.qid for r in rb] == [0, 1, 2]
        assert [r.success for r in rb] == [r.success for r in ra]
        assert all(r.success for r in rb)
    assert rows_t[1] - rows_t[0] < rows_t[0]
    if rows_t[0] == rows_j[0]:
        assert rows_t == rows_j
    assert tsv.store is tsv.session.store and tsv.engine.store is tsv.store


@pytest.mark.parametrize("kw", [
    dict(func="maxq", epsilon=0.3), dict(func="minq", epsilon=0.3),
    dict(func="min", epsilon=1.0), dict(func="max", epsilon=1.0),
    dict(func="proportion", epsilon=0.03,
         predicate=("and", (">", ("col", 0), 4.0), ("<", ("col", 0), 6.0))),
    dict(func="sum", epsilon_rel=0.02, group_by=True)])
def test_session_answers_host_shapes(cont, kw):
    """Each clause the pool cannot fuse answers on the HOST route (it
    raised NotImplementedError before the host route)."""
    ts = AQPSession(cont[1], **SESSION_KW)
    ts.submit(Request(query=Query(**kw)))
    (r,) = ts.drain()
    assert r.route is Route.HOST
    assert np.all(np.isfinite(np.asarray(r.theta, np.float64)))
    if kw["func"] not in ("min", "max"):    # bootstrap-inconsistent
        assert r.success and r.error <= (kw.get("epsilon") or np.inf)


@pytest.mark.parametrize("func", ["linreg", "logreg"])
def test_session_answers_regressions_like_the_reference(func):
    groups = _regression_groups()
    if func == "logreg":
        groups = [np.stack([g[:, 0], (g[:, 1] > 0.3).astype(np.float32)], 1)
                  for g in groups]
    jd = JGroupedData.from_group_arrays(groups)
    td = GroupedData.from_group_arrays(groups, device="cpu")
    kw = dict(func=func, epsilon=0.05 if func == "linreg" else 0.5)
    js, ts = JSession(jd, **SESSION_KW), AQPSession(td, **SESSION_KW)
    js.submit(JRequest(query=JQuery(**kw)))
    ts.submit(Request(query=Query(**kw)))
    (rj,), (rt,) = js.drain(), ts.drain()
    assert rt.route is Route.HOST and rt.theta.shape == (2, 2)
    assert rt.success == rj.success
    if np.array_equal(rt.n, np.asarray(rj.n)):
        assert_allclose(rt.theta, np.asarray(rj.theta),
                        rtol=1e-3 if func == "logreg" else 1e-4, atol=1e-5)
        assert_allclose(rt.error, rj.error, rtol=1e-3)


def test_session_refresh_and_reshuffle_follow_the_reference(cont):
    jd, td = cont
    kw = dict(SESSION_KW, reshuffle_every=2)
    js, ts = JSession(jd, **kw), AQPSession(td, **kw)
    for s, Q, R in ((js, JQuery, JRequest), (ts, Query, Request)):
        for q in (dict(func="median", epsilon=0.08),
                  dict(func="avg", epsilon=0.06, metric="linf")):
            s.submit(R(query=Q(**q)))
        s.drain()
    assert ts.store.epoch == js.store.epoch == 1
    assert ts.stats()["sample_epoch"] == js.stats()["sample_epoch"] == 1
    ts.refresh()
    js.refresh()
    assert ts.store.epoch == js.store.epoch == 2
    ts.submit(Request(query=Query(func="median", epsilon=0.08)))
    with pytest.raises(RuntimeError):
        ts.refresh()
    ts.drain()


def test_no_card_no_fallback():
    """Without a card the default device is still the card: building the
    table (and so any session or engine on it) raises instead of running
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the path without a CUDA card")
    vals = np.ones((100, 1), np.float32)
    with pytest.raises((RuntimeError, AssertionError)):
        AQPEngine(GroupedData(torch.from_numpy(vals).numpy(), [0, 50, 100]))
    with pytest.raises((RuntimeError, AssertionError)):
        AQPSession(GroupedData(vals, [0, 50, 100]))
