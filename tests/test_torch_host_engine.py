"""The port's AQP engine against the reference: the predicate AST
(canonical form, signature, compiled filter), Query validation, and
``AQPEngine.execute`` on every Listing-1 clause the host route serves --
predicates, relative bounds, linf/l1/lp/diff/order metrics, quantiles, and
GROUP BY through the grouped lane block -- plus ``AQPEngine.exact`` (the
segment-aggregate kernel's plain version on the CPU) against the
reference's ``exact_answer``.

Both engines run on the CPU with ``use_kernel="auto"``: the generic
bootstrap in both.  Whole runs follow tests/test_torch_host_parity.py's contract
with theta rtol 1e-5 and error rtol 1e-4 (2e-3 for var/std); grouped runs
hold each group's lane to the fused-lane form of that contract.  ``exact`` holds rtol 1e-5 (1e-4 for var/std, a float64
finish of f32 moment sums against the reference's two-pass f32).
"""
import numpy as np
import pytest
import torch

from repro.aqp import engine as jeng
from repro.aqp import query as jq
from repro.core import estimators as je
from repro.core.l2miss import exact_answer as j_exact
from repro.data import make_grouped as j_make_grouped
from repro_torch.aqp import engine as teng
from repro_torch.aqp import query as tq
from repro_torch.core.fused import resolve_ext_cap
from repro_torch.data import make_grouped as t_make_grouped
from test_torch_host_parity import (_lane, assert_fused_lane_parity,
                               assert_trace_parity)

DISTS = (["normal", "exp", "uniform"], 150_000)
TABLE = dict(seed=1, biases=[5.0, 3.0, 4.2])
ENGINE = dict(B=150, n_min=400, n_max=800, seed=0)

PREDICATES = [
    (">", ("col", 0), 4.5),
    ("and", ("<", ("col", 0), 6), (">=", ("col", 0), 3.5)),
    ("or", ("and", ("<", 1, ("col", 0)), ("<", ("col", 0), 2)),
     ("not", ("==", ("col", 0), ("col", 0)))),
    ("!=", 5, ("col", 0)),
    ("not", ("not", ("<=", ("col", 0), 4))),
    ("and", ("and", (">", ("col", 0), 1), (">", ("col", 0), 1))),
]
MALFORMED = [True, ("col",), ("col", -1), ("lit", "x"), ("<", ("col", 0)),
             ("and",), ("not", ("col", 0)), ("xor", 1, 2),
             ("and", ("col", 0), ("<", 1, 2)), ("<", ("<", 1, 2), 3)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jdata():
    return j_make_grouped(*DISTS, **TABLE)


@pytest.fixture(scope="module")
def tdata():
    return t_make_grouped(*DISTS, **TABLE, device="cpu")


@pytest.mark.parametrize("pred", PREDICATES)
def test_predicate_ast_matches_reference(jdata, tdata, pred):
    assert tq.canonicalize_predicate(pred) == jq.canonicalize_predicate(pred)
    assert tq.predicate_signature(pred) == jq.predicate_signature(pred)
    want = jq.compile_predicate(pred)(np.asarray(jdata.values))
    got = tq.compile_predicate(pred)(tdata.values)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


def test_malformed_predicates_and_queries_raise():
    for bad in MALFORMED:
        with pytest.raises(ValueError):
            jq.canonicalize_predicate(bad)
        with pytest.raises(ValueError):
            tq.canonicalize_predicate(bad)
    assert tq.predicate_signature(None) == () and \
        tq.predicate_signature(lambda v: v[:, 0] > 0) is None
    for kw in (dict(func="avg", epsilon=0.1, metric="lp"),
               dict(func="avg", epsilon=0.1, lp=2.0),
               dict(func="avg", epsilon=0.1, metric="lp", lp=0.5),
               dict(func="avg"), dict(func="avg", epsilon=0.1,
                                      epsilon_rel=0.1),
               dict(func="avg", epsilon=0.1, metric="l3"),
               dict(func="count", epsilon=1.0, predicate=("<", 1))):
        with pytest.raises(ValueError):
            jq.Query(**kw)
        with pytest.raises(ValueError):
            tq.Query(**kw)
    tq.Query(func="avg", metric="order")          # no bound needed


QUERIES = [
    dict(func="avg", epsilon=0.06, metric="linf"),
    dict(func="sum", epsilon=12000.0, metric="l1"),
    dict(func="var", epsilon=0.1, metric="lp", lp=3.0),
    dict(func="std", epsilon=0.06, metric="diff"),
    dict(func="avg", metric="order"),
    dict(func="avg", epsilon_rel=0.01),
    dict(func="count", epsilon=3000.0, predicate=(">", ("col", 0), 4.5)),
    dict(func="proportion", epsilon=0.02,
         predicate=("and", ("<", ("col", 0), 5.0), (">", ("col", 0), 3.8))),
    dict(func="median", epsilon=0.06),
    dict(func="maxq", epsilon_rel=0.05),
]


def _l2_eps(q, je_, m):
    """The L2 epsilon a run of ``q`` uses, after any Gamma conversion."""
    if q.metric == "order":
        return None
    eps = q.epsilon if q.epsilon is not None else q.epsilon_rel * \
        je_._pilot_scale(q)
    return {"l1": eps / np.sqrt(m), "diff": eps / np.sqrt(2.0)}.get(
        q.metric, eps)


@pytest.mark.parametrize("kw", QUERIES, ids=lambda kw: "-".join(
    str(v) for v in kw.values())[:40])
def test_execute_matches_reference(jdata, tdata, kw):
    j_eng, t_eng = jeng.AQPEngine(jdata, **ENGINE), teng.AQPEngine(tdata,
                                                                   **ENGINE)
    qj, qt = jq.Query(**kw), tq.Query(**kw)
    if qj.epsilon_rel is not None:
        np.testing.assert_allclose(t_eng._pilot_scale(qt),
                                   j_eng._pilot_scale(qj), rtol=1e-5)
    tj, tt = j_eng.execute(qj), t_eng.execute(qt)
    cfg = t_eng._config(qt, 0.0)
    if qj.metric == "order":
        ej, et = tj.info["order_bound_eps"], tt.info["order_bound_eps"]
    else:
        ej, et = _l2_eps(qj, j_eng, 3), _l2_eps(qt, t_eng, 3)
    cancels = qj.func in ("var", "std")
    how = assert_trace_parity(tj, tt, cfg, tdata.sizes, l=16, eps_j=ej,
                              eps_t=et, theta_rtol=1e-4 if cancels else 1e-5,
                              err_rtol=2e-3 if cancels else 1e-4)
    if how == "equal":
        assert t_eng.rows_touched == j_eng.rows_touched


@pytest.mark.parametrize("kw", [
    dict(func="avg", epsilon=0.05, group_by=True,
         predicate=(">", ("col", 0), 3.5)),
    dict(func="sum", epsilon_rel=0.02, group_by=True),
    dict(func="std", epsilon=0.05, group_by=True)])
def test_execute_grouped_matches_reference(jdata, tdata, kw):
    j_eng, t_eng = jeng.AQPEngine(jdata, **ENGINE), teng.AQPEngine(tdata,
                                                                   **ENGINE)
    rj, rt = j_eng.execute(jq.Query(**kw)), t_eng.execute(tq.Query(**kw))
    eps = (kw["epsilon"] if "epsilon" in kw
           else kw["epsilon_rel"] * t_eng._pilot_scale(tq.Query(**kw)))
    cancels = kw["func"] in ("var", "std")
    for g in range(3):
        assert_fused_lane_parity(
            _lane(rj, g), _lane(rt, g), eps=eps, l=10, n_cap=1 << 16,
            ext_cap=resolve_ext_cap(1 << 16, ENGINE["n_max"]),
            theta_rtol=1e-4 if cancels else 1e-5,
            err_rtol=2e-3 if cancels else 1e-4)
    with pytest.raises(ValueError):
        t_eng.execute(tq.Query(func="median", epsilon=0.1, group_by=True))
    with pytest.raises(ValueError):
        t_eng.execute(tq.Query(func="avg", epsilon=0.1, metric="linf",
                               group_by=True))


@pytest.mark.parametrize("func,pred", [
    ("avg", None), ("sum", None), ("var", None), ("std", None),
    ("count", (">", ("col", 0), 4.5)), ("proportion", ("<", ("col", 0), 4)),
    ("median", None), ("max", ("<", ("col", 0), 4))])
def test_exact_matches_reference(jdata, tdata, func, pred):
    """Moment functions through the segment-aggregate kernel's plain
    version (one call over all groups), the rest through ``evaluate``."""
    kw = dict(func=func, epsilon=1.0, predicate=pred)
    want = jeng.AQPEngine(jdata, **ENGINE).exact(jq.Query(**kw))
    t_eng = teng.AQPEngine(tdata, **ENGINE)
    got = t_eng.exact(tq.Query(**kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(
        got, want, rtol=1e-4 if func in ("var", "std") else 1e-5)
    if pred is None:
        np.testing.assert_allclose(got, j_exact(jdata, je.get(func)),
                                   rtol=1e-4)
    assert t_eng.rows_touched == 0          # exact answers sample nothing


def test_opaque_callable_predicate_runs_on_the_values_device(tdata):
    t_eng = teng.AQPEngine(tdata, **ENGINE)
    q = tq.Query(func="proportion", epsilon=0.05,
                 predicate=lambda v: v[:, 0] > 4.5)
    qa = tq.Query(func="proportion", epsilon=0.05,
                  predicate=(">", ("col", 0), 4.5))
    np.testing.assert_array_equal(t_eng.exact(q), t_eng.exact(qa))
    tr, ta = t_eng.execute(q), t_eng.execute(qa)
    assert tr.success and tr.error <= 0.05
    assert np.array_equal(tr.n, ta.n) and tr.error == ta.error
