"""The port's overload scheduling (``serve/slo.py`` and the pool's degrade,
shed, fair-queueing and migration machinery) against the JAX reference.

Mirrors ``tests/test_serve_slo.py`` and ``tests/test_serve_wfq.py`` on the
port, at their ``SPEC`` size, and adds:

* cross-package: ``predict_n0``, ``eps_for_budget``, the cost model's
  predictions, ``AdmissionController.plan``/``hopeless`` and
  ``FairQueue.stamp`` equal on the same observation sequences (both are
  host numpy, so equality is exact); a shed pilot's answer against the
  reference's within the generic bootstrap's tolerance;
* port-internal, bit for bit: a degraded lane equals a solo run at its
  delivered epsilon; a migrated lane equals its solo run, in a scenario
  built so that a migration happens (asserted); the policies armed but
  idle equal the policies off; a degraded answer is not cached.

Deadlines are either blown at submit, an hour away, or passed by a frozen
clock the test advances (the pool module's ``time`` is monkeypatched); the
cost model is primed through its own fields with fixed numbers.
"""
import dataclasses
import itertools
import math
import time
import types

import jax
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need the optional hypothesis extra")
import hypothesis.strategies as st

from repro.aqp.query import Query as JQuery
from repro.data import make_grouped as j_make_grouped
from repro.serve import lane_pool as jlp
from repro.serve import slo as jslo
from repro_torch.aqp.query import Query, Request
from repro_torch.core import estimators
from repro_torch.core import keys as keylib
from repro_torch.core.fused import bucket_ladder, fused_l2miss
from repro_torch.data import make_grouped
from repro_torch.serve import lane_pool as tlp
from repro_torch.serve import slo as tslo
from repro_torch.serve.lane_pool import LanePool, _Ticket
from repro_torch.serve.session import AQPSession
from repro_torch.serve.slo import (AdmissionController, CostModel,
                                   FairQueue, eps_for_budget, predict_n0)

SPEC = dict(B=100, n_min=300, n_max=600, l=6, max_iters=16, n_cap=1 << 13,
            ext_cap=1 << 10)
SESSION_SPEC = {k: v for k, v in SPEC.items() if k not in ("l", "ext_cap")}
HOUR = 3600.0


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return make_grouped(["normal", "exp"], 60_000, seed=1,
                        biases=[5.0, 3.0], device="cpu")


def _solo(data, func, key, eps, skey, **over):
    kw = {**SPEC, "est_name": func, **over}
    scale = (np.asarray(data.scale, np.float32)
             if estimators.get(func).needs_population_scale
             else np.ones(data.num_groups, np.float32))
    return fused_l2miss(data.values, data.offsets, scale, key, eps, 0.05,
                        sample_key=skey, **kw)


def _prime(cm, *, cheap_below, coef_func="avg", coef=None, ticks=4.0,
           cheap_s=1e-5, costly_s=10.0):
    """Prime a cost model: rungs <= cheap_below cheap, wider ones slow."""
    for w in cm.widths:
        cm._tick_s[w] = cheap_s if w <= cheap_below else costly_s
    cm._tick_s_any = cheap_s
    cm._ticks = float(ticks)
    if coef is not None:
        cm._coef[coef_func] = float(coef)


def _assert_same_run(r, ref):
    """A pool response equal to a solo FusedResult in every bit."""
    assert np.array_equal(ref.n.numpy(), r.n)
    assert int(ref.iterations) == r.iterations
    assert ref.theta.numpy().tobytes() == np.asarray(r.theta).tobytes()
    assert np.float32(ref.error).tobytes() == np.float32(r.error).tobytes()
    assert bool(ref.success) == r.success


# ---------------------------------------------------------------------------
# Eq. 13 both ways; the cost model and controller (host numpy)
# ---------------------------------------------------------------------------

def test_eps_for_budget_inverts_predict_n0():
    beta = np.array([0.8, 0.3, 0.15], np.float32)
    for eps in (0.2, 0.05, 0.01):
        n0 = predict_n0(beta, eps, n_min=1, margin=1.0)
        got = eps_for_budget(beta, float(n0.sum()))
        assert eps * 0.9 <= got <= eps * 1.001
    assert eps_for_budget(beta, 1_000.0) > eps_for_budget(beta, 10_000.0)


def test_unprimed_model_admits():
    ctl = AdmissionController(bucket_ladder(1 << 13, 600), num_groups=2,
                              n_min=300)
    plan = ctl.plan(func="avg", epsilon=0.01, deadline_at=1.0 + 1e-6,
                    now=0.0)
    assert plan.action == "admit" and plan.epsilon == 0.01


def test_controller_blown_deadline_sheds():
    ctl = AdmissionController(bucket_ladder(1 << 13, 600), num_groups=2,
                              n_min=300)
    assert ctl.plan(func="avg", epsilon=0.1, deadline_at=1.0,
                    now=2.0).action == "shed"


def test_controller_degrades_to_largest_fitting_rung():
    widths = bucket_ladder(1 << 13, 600)
    assert widths == (1024, 2048, 4096, 8192)
    eps = 0.03
    ctl = AdmissionController(widths, num_groups=2, n_min=300)
    _prime(ctl.cost, cheap_below=2048, coef=eps * math.sqrt(8192))
    plan = ctl.plan(func="avg", epsilon=eps, deadline_at=0.5, now=0.0)
    assert plan.action == "degrade"
    assert plan.epsilon == pytest.approx(eps * math.sqrt(8192 / 2048))
    tight = AdmissionController(widths, num_groups=2, n_min=300,
                                max_degrade=1.5)
    _prime(tight.cost, cheap_below=2048, coef=eps * math.sqrt(8192))
    assert tight.plan(func="avg", epsilon=eps, deadline_at=0.5,
                      now=0.0).action == "shed"


def _observations(seed):
    """A fixed sequence of rounds and retirements for both cost models."""
    rng = np.random.default_rng(seed)
    widths = bucket_ladder(1 << 13, 600)
    obs = []
    for _ in range(40):
        if rng.uniform() < 0.5:
            obs.append(("round", float(rng.uniform(1e-4, 0.05)),
                        int(rng.integers(1, 3)),
                        int(rng.choice(widths)) - int(rng.integers(0, 300))))
        else:
            obs.append(("retire", str(rng.choice(["avg", "var", "sum"])),
                        float(rng.uniform(0.01, 0.3)),
                        int(rng.integers(0, 8192)), int(rng.integers(0, 16))))
    return obs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_controller_equal_to_reference_on_the_same_observations(seed):
    """Both packages' cost models, controllers and fair queues fed the
    same observations give the same predictions and plans, exactly."""
    widths = bucket_ladder(1 << 13, 600)
    tc = AdmissionController(widths, num_groups=2, n_min=300)
    jc = jslo.AdmissionController(widths, num_groups=2, n_min=300)
    beta = np.asarray([0.4, 0.5, 0.45], np.float32)
    for i, ob in enumerate(_observations(seed)):
        for c in (tc, jc):
            if ob[0] == "round":
                c.cost.observe_round(*ob[1:])
            else:
                c.cost.observe_retirement(*ob[1:])
        for func, eps in itertools.product(("avg", "var", "sum"),
                                           (0.01, 0.05, 0.2)):
            for wn0 in (None, np.asarray([700, 2500])):
                assert tc.cost.predict_service_s(func, eps, warm_n0=wn0) \
                    == jc.cost.predict_service_s(func, eps, warm_n0=wn0)
                for ddl in (None, 1e-4, 0.01, 0.5, HOUR):
                    kw = dict(func=func, epsilon=eps, now=0.0,
                              deadline_at=ddl, warm_n0=wn0,
                              warm_beta=None if wn0 is None else beta)
                    assert dataclasses.astuple(tc.plan(**kw)) == \
                        dataclasses.astuple(jc.plan(**kw)), (i, kw)
        for q, b in ((0, 0), (3, 2), (12, 4)):
            kw = dict(queue_ahead=q, busy=b, lanes=4, deadline_at=0.05,
                      now=0.0)
            assert tc.hopeless(**kw) == jc.hopeless(**kw)
    for eps in (0.3, 0.05, 0.004):
        for margin in (1.0, 1.1):
            assert np.array_equal(
                predict_n0(beta, eps, n_min=300, margin=margin),
                jslo.predict_n0(beta, eps, n_min=300, margin=margin))
        assert eps_for_budget(beta, 1 / eps) == \
            jslo.eps_for_budget(beta, 1 / eps)
    tq = FairQueue({"a": 3.0, "b": 1.0}, default_weight=0.5)
    jq = jslo.FairQueue({"a": 3.0, "b": 1.0}, default_weight=0.5)
    rng = np.random.default_rng(seed)
    for _ in range(200):
        t = str(rng.choice(["a", "b", "c"]))
        cost = float(rng.uniform(1, 5000))
        assert tq.stamp(t, cost) == jq.stamp(t, cost)
        if rng.uniform() < 0.4:
            v = float(rng.uniform(0, tq.v + 10))
            tq.on_admit(v)
            jq.on_admit(v)
        assert tq.v == jq.v


# ---------------------------------------------------------------------------
# Load shedding: pilot answers, delivered contract
# ---------------------------------------------------------------------------

def test_shed_at_submit_blown_deadline(data):
    pool = LanePool(data, lanes=2, tiers=1, degrade=True, seed=0, **SPEC)
    qid = pool.submit(Query("avg", epsilon=0.01),
                      deadline_at=time.perf_counter() - 1.0)
    assert qid in pool.results and pool.busy_lanes == 0 \
        and pool.queue_depth == 0 and pool.ticks == 0
    r = pool.results.pop(qid)
    assert r.shed and not r.degraded and r.iterations == 0 and r.tier == -1
    assert r.epsilon == 0.01
    assert r.error <= r.delivered_epsilon
    assert r.delivered_epsilon >= r.epsilon
    assert r.delivered_B == max(16, SPEC["B"] // 4)
    assert np.all(r.n == np.minimum(np.diff(data.offsets), SPEC["n_min"]))
    assert r.theta.shape == (data.num_groups, 1)
    assert pool.stats()["shed"] == 1


@pytest.mark.parametrize("func", ["avg", "var", "sum"])
def test_shed_pilot_matches_reference(data, func):
    """The shed pilot (the generic bootstrap over n_min rows a group,
    gathered from the resident table) against the reference's, same key
    and sample key: theta rtol 1e-5, error rtol 1e-4 (the host route's
    tolerance)."""
    jd = j_make_grouped(["normal", "exp"], 60_000, seed=1, biases=[5.0, 3.0])
    skey = jax.random.PRNGKey(11)
    key = jax.random.PRNGKey(5)
    eps = 0.01 if func != "sum" else 100.0
    jp = jlp.LanePool(jd, lanes=2, tiers=1, degrade=True, seed=0,
                      sample_key=skey, **SPEC)
    tp = LanePool(data, lanes=2, tiers=1, degrade=True, seed=0,
                  sample_key=np.asarray(skey), **SPEC)
    qj = jp.submit(JQuery(func, epsilon=eps), key=key, deadline_at=-1.0)
    qt = tp.submit(Query(func, epsilon=eps), key=np.asarray(key),
                   deadline_at=-1.0)
    rj, rt = jp.results.pop(qj), tp.results.pop(qt)
    assert rt.shed and rj.shed
    assert np.array_equal(rt.n, np.asarray(rj.n))
    np.testing.assert_allclose(rt.theta, np.asarray(rj.theta), rtol=1e-5)
    np.testing.assert_allclose(rt.error, rj.error, rtol=1e-4)
    assert rt.delivered_B == rj.delivered_B


def _frozen_clock(monkeypatch):
    """Freeze the pool module's clock; returns the cell the test moves."""
    now = [time.perf_counter()]
    monkeypatch.setattr(tlp, "time",
                        types.SimpleNamespace(perf_counter=lambda: now[0]))
    return now


def test_queued_ticket_shed_when_deadline_passes(data, monkeypatch):
    """A ticket whose deadline passes while it queues behind busy lanes is
    swept at the next refill, pilot-answered, and never takes a lane."""
    now = _frozen_clock(monkeypatch)
    pool = LanePool(data, lanes=2, tiers=1, degrade=True, seed=0, **SPEC)
    q0 = pool.submit(Query("avg", epsilon=0.02))
    q1 = pool.submit(Query("avg", epsilon=0.02))
    pool.tick()
    assert pool.busy_lanes == 2
    q2 = pool.submit(Query("avg", epsilon=0.05), deadline_at=now[0] + 10.0)
    assert pool.queue_depth == 1
    now[0] += 20.0                     # the deadline passes in the queue
    pool.tick()
    assert q2 in pool.results
    r = pool.results.pop(q2)
    assert r.shed and r.error <= r.delivered_epsilon
    assert r.delivered_B == max(16, SPEC["B"] // 4)
    out = pool.drain()
    assert {o.qid for o in out} == {q0, q1}
    assert all(not o.shed and not o.degraded for o in out)
    assert pool.stats()["shed"] == 1


# ---------------------------------------------------------------------------
# Deadline-driven degradation
# ---------------------------------------------------------------------------

def test_degraded_lane_matches_solo_at_delivered_epsilon(data):
    """Degradation relaxes the bound at admission and nothing else: the
    lane equals a solo run at the delivered epsilon, bit for bit."""
    eps_req = 0.03
    skey = keylib.prng_key(11)
    key = keylib.prng_key(5)
    pool = LanePool(data, lanes=2, tiers=1, degrade=True, seed=0,
                    sample_key=skey, **SPEC)
    _prime(pool._slo.cost, cheap_below=2048,
           coef=eps_req * math.sqrt(SPEC["n_cap"]))
    qid = pool.submit(Query("avg", epsilon=eps_req), key=key,
                      deadline_at=time.perf_counter() + HOUR / 7200)
    r = next(o for o in pool.drain() if o.qid == qid)
    assert r.degraded and not r.shed
    assert r.epsilon == eps_req
    assert r.delivered_epsilon == pytest.approx(
        eps_req * math.sqrt(SPEC["n_cap"] / 2048))
    assert r.success and r.error <= r.delivered_epsilon
    assert pool.stats()["degraded"] == 1
    _assert_same_run(r, _solo(data, "avg", key, r.delivered_epsilon, skey))


def test_degrade_off_is_exact_special_case(data):
    pool = LanePool(data, lanes=2, tiers=1, seed=0, **SPEC)
    qid = pool.submit(Query("avg", epsilon=0.05),
                      deadline_at=time.perf_counter() - 1.0)
    r = next(o for o in pool.drain() if o.qid == qid)
    assert not r.shed and not r.degraded and r.iterations > 0
    assert r.delivered_epsilon == r.epsilon == 0.05
    s = pool.stats()
    assert s["shed"] == 0 and s["degraded"] == 0 and s["migrations"] == 0


def test_policies_armed_but_idle_equal_policies_off(data):
    """Degrade and fair queueing armed, with no deadline and one tenant,
    change nothing: every answer and lane equals the plain pool's."""
    skey = keylib.prng_key(42)
    keys = keylib.split(keylib.prng_key(11), 5)
    work = [("avg", 0.06), ("var", 0.25), ("std", 0.3), ("avg", 0.1),
            ("var", 0.2)]
    runs = []
    for kw in ({}, dict(degrade=True, wfq=True,
                        tenant_weights={"x": 2.0})):
        pool = LanePool(data, lanes=4, seed=5, sample_key=skey, **SPEC,
                        **kw)
        for (f, e), k in zip(work, keys):
            pool.submit(Query(f, epsilon=e), key=k)
        runs.append(pool.drain())
    for a, b in zip(*runs):
        assert (a.qid, a.lane, a.tier, a.iterations) == \
            (b.qid, b.lane, b.tier, b.iterations)
        assert np.array_equal(a.n, b.n) and a.error == b.error
        assert a.theta.tobytes() == b.theta.tobytes()
        assert not (b.shed or b.degraded)


# ---------------------------------------------------------------------------
# Cross-tier lane migration
# ---------------------------------------------------------------------------

def test_migrated_lane_bit_equal_to_solo(data):
    """The straggler (epsilon 0.03) and a burst lane (0.12) fill tier 0, two
    mediums (0.05) tier 1; the young query queues and takes the burst's
    freed lane beside the straggler.  Once the mediums retire, the
    straggler alone drives tier 0's bucket and moves into the empty tier 1.
    The move happens here (asserted), and both the moved lane and its old
    tier-mate equal their solo runs bit for bit."""
    skey = keylib.prng_key(21)
    keys = [keylib.prng_key(31 + i) for i in range(5)]
    pool = LanePool(data, lanes=4, tiers=2, migrate=True, seed=0,
                    sample_key=skey, **SPEC)
    eps = [0.03, 0.12, 0.05, 0.05, 0.05]
    qids = [pool.submit(Query("avg", epsilon=e), key=k)
            for e, k in zip(eps, keys)]
    out = {o.qid: o for o in pool.drain()}
    rs, ry = out[qids[0]], out[qids[4]]
    assert ry.tier == 0 and ry.migrations == 0
    assert pool.migrations >= 1 and rs.migrations >= 1 and rs.tier == 1
    assert pool.stats()["migrations"] == pool.migrations
    for r, e, k in ((rs, 0.03, keys[0]), (ry, 0.05, keys[4])):
        assert r.success
        _assert_same_run(r, _solo(data, "avg", k, e, skey))


def test_migration_off_never_moves(data):
    skey = keylib.prng_key(21)
    pool = LanePool(data, lanes=4, tiers=2, seed=0, sample_key=skey, **SPEC)
    for i, e in enumerate([0.03, 0.12, 0.05, 0.05, 0.05]):
        pool.submit(Query("avg", epsilon=e), key=keylib.prng_key(31 + i))
    out = pool.drain()
    assert pool.migrations == 0 and all(o.migrations == 0 for o in out)


# ---------------------------------------------------------------------------
# Session plumbing
# ---------------------------------------------------------------------------

def test_session_shed_and_contract_fields(data):
    sess = AQPSession(data, degrade=True, seed=0, **SESSION_SPEC)
    t = sess.submit(Request(Query("avg", epsilon=0.01), deadline_s=1e-9))
    r = None
    for _ in range(1000):
        sess.pump()
        r = sess.poll(t)
        if r is not None:
            break
    assert r is not None and r.shed
    assert r.epsilon == 0.01 and r.delivered_epsilon >= r.epsilon
    assert r.error <= r.delivered_epsilon
    assert r.slo_met is False
    assert sess.stats()["pool"]["shed"] == 1
    t2 = sess.submit(Request(Query("avg", epsilon=0.05), deadline_s=HOUR))
    r2 = next(o for o in sess.drain() if o.rid == t2.rid)
    assert not r2.shed and not r2.degraded and r2.success
    assert r2.delivered_epsilon == r2.epsilon == 0.05


def test_session_degraded_not_cached(data):
    """A degraded answer meets only the relaxed bound, so it must not teach
    the warm cache an entry keyed on the requested epsilon."""
    sess = AQPSession(data, degrade=True, warm_cache=True, seed=0,
                      **SESSION_SPEC)
    sess.submit(Request(Query("avg", epsilon=0.03), deadline_s=HOUR))
    sess.drain()
    pool = sess._pool
    assert pool is not None and pool._slo is not None
    _prime(pool._slo.cost, cheap_below=2048, coef_func="var",
           coef=0.03 * math.sqrt(SPEC["n_cap"]))
    t = sess.submit(Request(Query("var", epsilon=0.03), deadline_s=0.5))
    r = next(o for o in sess.drain() if o.rid == t.rid)
    assert r.degraded and r.delivered_epsilon > r.epsilon
    kind, _ = sess.cache.lookup(
        sess.cache.signature(Query("var", epsilon=0.03)), epsilon=0.03)
    assert kind != "exact"


def test_session_fair_queue_admits_by_weight(data, monkeypatch):
    """Two tenants' backlogs behind two busy lanes: the weight-3 tenant
    gets three admissions for the weight-1 tenant's one (unit costs while
    the cost model is unprimed)."""
    _frozen_clock(monkeypatch)
    pool = LanePool(data, lanes=2, tiers=1, wfq=True,
                    tenant_weights={"dash": 3.0, "batch": 1.0}, seed=0,
                    **SPEC)
    tickets = {}
    for i in range(8):
        for tenant in ("batch", "dash"):
            q = pool.submit(Query("avg", epsilon=0.2), tenant=tenant)
            tickets[q] = tenant
    order = sorted(pool._queue, key=lambda t: t.order)
    first = [tickets[t.qid] for t in order[:8]]
    assert first.count("dash") == 6 and first.count("batch") == 2
    out = pool.drain()
    assert len(out) == 16 and all(o.success for o in out)
    assert {o.tenant for o in out} == {"dash", "batch"}


def test_shed_pilot_tables_once_per_epoch(data):
    """Sheds of one sample epoch share one pilot table, gathered on the
    table's device; a rotation of the sample key rebuilds it, and a pilot
    after the rotation equals a fresh pool's under the new key."""
    pool = LanePool(data, lanes=2, tiers=1, degrade=True, seed=0, **SPEC)
    for func in ("avg", "var"):
        pool.submit(Query(func, epsilon=0.01), key=keylib.prng_key(1),
                    deadline_at=-1.0)
    tab = pool._pilot_tab
    assert tab is not None and tab.device == data.values.device
    pool.submit(Query("avg", epsilon=0.01), deadline_at=-1.0)
    assert pool._pilot_tab is tab and pool.stats()["shed"] == 3
    pool.set_sample_key(keylib.prng_key(77))
    assert pool._pilot_tab is None
    q = pool.submit(Query("avg", epsilon=0.01), key=keylib.prng_key(1),
                    deadline_at=-1.0)
    fresh = LanePool(data, lanes=2, tiers=1, degrade=True, seed=0,
                     sample_key=keylib.prng_key(77), **SPEC)
    qf = fresh.submit(Query("avg", epsilon=0.01), key=keylib.prng_key(1),
                      deadline_at=-1.0)
    a, b = pool.results[q], fresh.results[qf]
    assert a.theta.tobytes() == b.theta.tobytes() and a.error == b.error
    assert not torch.equal(pool._pilot_tab, tab)


# ---------------------------------------------------------------------------
# Admission order (tests/test_serve_wfq.py on the port)
# ---------------------------------------------------------------------------

_INF = float("inf")


def _tk(qid, *, priority=0, deadline_at=None, vft=0.0, tenant=""):
    return _Ticket(qid=qid, func="avg", fid=0, epsilon=0.05, delta=0.05,
                   key=np.zeros(2, np.uint32), scale_row=np.ones(1),
                   submitted_s=0.0, priority=priority, deadline_at=deadline_at,
                   tenant=tenant, vft=vft)


priorities = st.integers(min_value=-3, max_value=3)
deadlines = st.one_of(st.none(), st.floats(min_value=0.0, max_value=100.0,
                                           allow_nan=False))
vfts = st.floats(min_value=0.0, max_value=1e6, allow_nan=False)


@hypothesis.given(st.lists(st.tuples(priorities, deadlines, vfts),
                           min_size=1, max_size=40))
@hypothesis.settings(max_examples=100, deadline=None)
def test_order_is_a_strict_total_order(rows):
    tks = [_tk(i, priority=p, deadline_at=d, vft=v)
           for i, (p, d, v) in enumerate(rows)]
    keys = [t.order for t in tks]
    assert len(set(keys)) == len(keys)
    a = sorted(tks, key=lambda t: t.order)
    b = sorted(tks[::-1], key=lambda t: t.order)
    assert [t.qid for t in a] == [t.qid for t in b]
    # The reference's ticket orders the same rows the same way.
    jt = [jlp._Ticket(qid=t.qid, func="avg", fid=0, epsilon=0.05,
                      delta=0.05, key=np.zeros(2, np.uint32),
                      scale_row=np.ones(1), submitted_s=0.0,
                      priority=t.priority, deadline_at=t.deadline_at,
                      vft=t.vft) for t in tks]
    assert [t.order for t in jt] == keys


@hypothesis.given(st.lists(st.tuples(priorities, deadlines),
                           min_size=2, max_size=40))
@hypothesis.settings(max_examples=100, deadline=None)
def test_fifo_within_priority_deadline_ties(rows):
    tks = [_tk(i, priority=p, deadline_at=d) for i, (p, d) in enumerate(rows)]
    ranked = sorted(tks, key=lambda t: t.order)
    for x, y in itertools.combinations(range(len(ranked)), 2):
        a, b = ranked[x], ranked[y]
        if a.priority == b.priority and a.deadline_at == b.deadline_at:
            assert a.qid < b.qid
    legacy = sorted(tks, key=lambda t: (
        -t.priority, t.deadline_at if t.deadline_at is not None else _INF,
        t.qid))
    assert [t.qid for t in ranked] == [t.qid for t in legacy]


@hypothesis.given(st.lists(st.tuples(priorities, deadlines, vfts),
                           min_size=2, max_size=40))
@hypothesis.settings(max_examples=100, deadline=None)
def test_priority_dominates_vft_dominates_deadline(rows):
    tks = [_tk(i, priority=p, deadline_at=d, vft=v)
           for i, (p, d, v) in enumerate(rows)]
    ranked = sorted(tks, key=lambda t: t.order)
    for a, b in zip(ranked, ranked[1:]):
        assert a.priority >= b.priority
        if a.priority == b.priority:
            assert a.vft <= b.vft


@hypothesis.given(
    st.lists(st.tuples(st.sampled_from(["a", "b", "c"]),
                       st.floats(min_value=1.0, max_value=1e4,
                                 allow_nan=False)),
             min_size=1, max_size=60))
@hypothesis.settings(max_examples=100, deadline=None)
def test_vft_strictly_increasing_per_tenant(stamps):
    fq = FairQueue({"a": 2.0, "b": 1.0, "c": 0.5})
    last = {}
    for tenant, cost in stamps:
        vft = fq.stamp(tenant, cost)
        if tenant in last:
            assert vft > last[tenant]
        last[tenant] = vft


@hypothesis.given(st.integers(min_value=1, max_value=8),
                  st.integers(min_value=1, max_value=8))
@hypothesis.settings(max_examples=50, deadline=None)
def test_backlogged_service_proportional_to_weights(wa, wb):
    fq = FairQueue({"a": float(wa), "b": float(wb)})
    head = {t: fq.stamp(t, 1.0) for t in ("a", "b")}
    served = {"a": 0, "b": 0}
    rounds = 200
    for _ in range(rounds):
        t = min(head, key=lambda k: (head[k], k))
        fq.on_admit(head[t])
        served[t] += 1
        head[t] = fq.stamp(t, 1.0)
    assert abs(served["a"] - rounds * wa / (wa + wb)) <= 2


@hypothesis.given(st.integers(min_value=1, max_value=50),
                  st.floats(min_value=0.1, max_value=10.0, allow_nan=False),
                  st.floats(min_value=0.1, max_value=10.0, allow_nan=False))
@hypothesis.settings(max_examples=100, deadline=None)
def test_no_starvation_bounded_overtake(n_heavy, w_light, w_heavy):
    fq = FairQueue({"light": w_light, "heavy": w_heavy})
    light_vft = fq.stamp("light", 1.0)
    heavies = [fq.stamp("heavy", 1.0) for _ in range(n_heavy)]
    bound = int(np.ceil(w_heavy / w_light))
    assert sum(v < light_vft for v in heavies) <= bound
    queue = [("heavy", v) for v in heavies] + [("light", light_vft)]
    queue.sort(key=lambda kv: (kv[1], kv[0]))
    assert next(i for i, kv in enumerate(queue) if kv[0] == "light") <= bound


def test_unknown_tenant_uses_default_weight():
    fq = FairQueue({"a": 4.0}, default_weight=2.0)
    assert fq.weight("a") == 4.0
    assert fq.weight("stranger") == 2.0
    assert fq.weight("") == 2.0
    with pytest.raises(ValueError):
        FairQueue({"a": 0.0})
    with pytest.raises(ValueError):
        CostModel(())
    assert tslo.PILOT_B_FLOOR == jslo.PILOT_B_FLOOR
