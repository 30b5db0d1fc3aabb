"""The port's warm cache against the JAX reference: cache signatures, the
``WarmCache`` LRU, warm-started fused lanes and blocks, and the session's
WARM route.

Mirrors ``tests/test_serve_warm_cache.py`` on the port, at its size (all
but ``test_sharded_step_memo_is_bounded``: the sharded pool is not ported),
and adds:

* cross-package: ``cache_signature`` (predicate ASTs included) and
  ``WarmCache.predict_n0`` equal to the reference's; warm ``fused_l2miss``
  runs against the reference's on the same keys, integers exact (a warm
  lane's tick 0 takes ``warm_n0`` as it is, and these fixtures verify in
  one or two ticks), theta rtol 1e-5, error rtol 1e-4; a warm pool block
  against the reference pool's warm block (integers exact, theta rtol
  1e-5, error rtol 1e-3: the grouped tolerance); one tick from a converted
  warm state;
* port-internal, bit for bit: a warm pool lane equals its solo warm run, a
  warm block its warm ``fused_grouped`` run; an exact repeat moves neither
  the pool's dispatch counter nor either bootstrap kernel's launch counter;
  a cold request in a warm-enabled session equals its solo run.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.aqp import query as jq
from repro.core import fused as jf
from repro.data import make_grouped as j_make_grouped
from repro.serve import LanePool as JPool
from repro.serve import warm_cache as jwc
from repro_torch import convert
from repro_torch.aqp.query import (Query, Request, cache_signature,
                                   canonicalize_predicate, compile_predicate,
                                   epsilon_bucket, predicate_signature)
from repro_torch.core import fused as tf
from repro_torch.core import keys as keylib
from repro_torch.data import make_grouped
from repro_torch.kernels.poisson_bootstrap import ops as pb_ops
from repro_torch.kernels.segment_agg import ops as seg_ops
from repro_torch.serve import (AQPService, AQPSession, LanePool, Planner,
                               Route, WarmCache, WarmEntry)
from repro_torch.serve.warm_cache import WARM_MARGIN, CachedAnswer

KW = dict(B=100, n_min=300, n_max=600, max_iters=16, n_cap=1 << 13, seed=0,
          reshuffle_every=1000)
FUSED = dict(est_name="avg", B=100, n_min=300, n_max=600, l=4,
             max_iters=16, n_cap=1 << 13, ext_cap=1 << 13)
SKEY = 42


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    args = (["normal", "exp"], 60_000)
    kw = dict(seed=1, biases=[5.0, 3.0])
    return (j_make_grouped(*args, **kw),
            make_grouped(*args, **kw, device="cpu"))


@pytest.fixture(scope="module")
def data(pair):
    return pair[1]


# ---------------------------------------------------------------------------
# Predicate canonicalization: property tests over a seeded AST generator
# ---------------------------------------------------------------------------

def _rand_ast(rng: random.Random, depth: int = 0):
    """A random well-formed boolean predicate AST over 3 columns."""
    def leaf():
        if rng.random() < 0.5:
            return ("col", rng.randrange(3))
        x = rng.choice([0, 1, 2, 5, -3])
        return x if rng.random() < 0.5 else ("lit", float(x))

    r = rng.random()
    if depth >= 3 or r < 0.55:
        op = rng.choice(["<", "<=", ">", ">=", "==", "!="])
        return (op, leaf(), leaf())
    if r < 0.7:
        return ("not", _rand_ast(rng, depth + 1))
    op = rng.choice(["and", "or"])
    kids = [_rand_ast(rng, depth + 1) for _ in range(rng.randrange(1, 4))]
    return (op,) + tuple(kids)


def _shuffled(rng: random.Random, ast):
    """A semantically equal rewrite: permute symmetric and boolean operands,
    flip comparison orientation, swap int and float literals."""
    if not isinstance(ast, tuple):
        return float(ast) if rng.random() < 0.5 else ast
    op = ast[0]
    if op == "lit":
        x = ast[1]
        return ("lit", int(x) if float(x).is_integer() and rng.random() < 0.5
                else float(x))
    if op == "col":
        return ast
    if op == "not":
        return ("not", _shuffled(rng, ast[1]))
    if op in ("==", "!="):
        a, b = (_shuffled(rng, x) for x in ast[1:])
        return (op, b, a) if rng.random() < 0.5 else (op, a, b)
    if op in ("<", "<=", ">", ">="):
        a, b = (_shuffled(rng, x) for x in ast[1:])
        if rng.random() < 0.5:
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}[op]
            return (flip, b, a)
        return (op, a, b)
    kids = [_shuffled(rng, k) for k in ast[1:]]
    rng.shuffle(kids)
    return (op,) + tuple(kids)


def test_canonicalize_idempotent_and_semantics_preserving():
    rng = random.Random(7)
    vals = torch.as_tensor(np.asarray(
        random.Random(8).choices([0, 1, 2, 5, -3], k=60),
        np.float32).reshape(20, 3))
    for _ in range(200):
        ast = _rand_ast(rng)
        canon = canonicalize_predicate(ast)
        assert canonicalize_predicate(canon) == canon
        assert canon == jq.canonicalize_predicate(ast)
        assert torch.equal(compile_predicate(ast)(vals),
                           compile_predicate(canon)(vals))


def test_canonicalize_rewrite_invariant():
    rng = random.Random(9)
    for _ in range(200):
        ast = _rand_ast(rng)
        assert (canonicalize_predicate(_shuffled(rng, ast))
                == canonicalize_predicate(ast))


def test_canonicalize_examples():
    assert canonicalize_predicate((">", ("col", 0), 5)) == \
        ("<", ("lit", 5.0), ("col", 0))
    assert canonicalize_predicate(("lit", 5)) == \
        canonicalize_predicate(("lit", 5.0))
    a = ("<", ("col", 0), ("lit", 1.0))
    b = ("<", ("col", 1), ("lit", 2.0))
    assert canonicalize_predicate(("and", ("and", a, b), a)) == \
        canonicalize_predicate(("and", a, b))
    assert canonicalize_predicate(("and", a)) == a
    assert canonicalize_predicate(("not", ("not", a))) == a


@pytest.mark.parametrize("bad", [
    True, ("lit", True), ("col", 1.5), ("col", -1), ("nope", 1, 2),
    ("<", ("col", 0)), ("<", ("and",), ("col", 0)), ("not", ("col", 0)),
    ("and",), ("and", ("col", 0), ("col", 1)), (),
])
def test_canonicalize_rejects_malformed(bad):
    with pytest.raises(ValueError):
        canonicalize_predicate(bad)


def test_predicate_signature_forms():
    assert predicate_signature(None) == ()
    assert predicate_signature(lambda v: v[:, 0] > 0) is None
    assert predicate_signature((">", ("col", 0), 1)) == \
        ("<", ("lit", 1.0), ("col", 0))


# ---------------------------------------------------------------------------
# Cache signature + epsilon bucketing
# ---------------------------------------------------------------------------

def test_cache_signature_epsilon_bucketing():
    q1 = Query(func="avg", epsilon=0.100)
    q2 = Query(func="avg", epsilon=0.101)
    q3 = Query(func="avg", epsilon=0.30)
    s1, s2, s3 = (cache_signature(q) for q in (q1, q2, q3))
    assert s1 == s2
    assert s1[0] == s3[0] and s1[1] != s3[1]
    assert epsilon_bucket(0.25) == epsilon_bucket(0.25 * (1 + 1e-12))


def test_cache_signature_distinguishes_kind_epoch_and_callable():
    abs_q = Query(func="avg", epsilon=0.1)
    rel_q = Query(func="avg", epsilon_rel=0.1)
    assert cache_signature(abs_q)[0] != cache_signature(rel_q)[0]
    assert cache_signature(abs_q, dataset_epoch=1) != cache_signature(abs_q)
    assert cache_signature(
        Query(func="avg", epsilon=0.1, predicate=lambda v: v[:, 0] > 0)) \
        is None
    pa = Query(func="count", epsilon=0.1, predicate=(">", ("col", 0), 2))
    pb = Query(func="count", epsilon=0.1,
               predicate=("<", ("lit", 2.0), ("col", 0)))
    assert cache_signature(pa) == cache_signature(pb)
    with pytest.raises(ValueError):
        cache_signature(Query(func="avg", epsilon=0.1, group_by=True))


def test_cache_signature_equal_to_reference():
    """Same queries, same signatures, predicate ASTs included."""
    rng = random.Random(11)
    funcs = ["avg", "sum", "count", "var", "median"]
    for i in range(300):
        pred = None if i % 4 == 0 else _rand_ast(rng)
        eps = 10 ** rng.uniform(-4, 2)
        kind = rng.choice(["abs", "rel", "order", "lp"])
        kw = dict(func=rng.choice(funcs), predicate=pred,
                  delta=rng.choice([0.05, 0.1]),
                  group_by=rng.random() < 0.3)
        if kind == "abs":
            kw["epsilon"] = eps
        elif kind == "rel":
            kw["epsilon_rel"] = eps
        elif kind == "order":
            kw["metric"] = "order"
        else:
            kw.update(metric="lp", lp=rng.choice([1.0, 3.0]), epsilon=eps)
        ep, g = rng.randrange(3), rng.choice([2, 9])
        assert cache_signature(Query(**kw), dataset_epoch=ep, num_groups=g) \
            == jq.cache_signature(jq.Query(**kw), dataset_epoch=ep,
                                  num_groups=g)
        assert epsilon_bucket(eps) == jq.epsilon_bucket(eps)


# ---------------------------------------------------------------------------
# WarmCache LRU
# ---------------------------------------------------------------------------

def _entry(eps=0.1, answer=True):
    beta = np.asarray([1.0, 0.5, 0.5], np.float32)
    n = np.asarray([800, 900], np.int64)
    ans = CachedAnswer(theta=np.ones((2, 1)), error=eps / 2, success=True,
                       n=n.copy(), epsilon=eps) if answer else None
    return WarmEntry(beta=beta, n_star=n, iterations=5, epsilon=eps,
                     answer=ans)


def _sig(eps, func="avg"):
    return cache_signature(Query(func=func, epsilon=eps))


def test_warm_cache_lru_eviction_order():
    c = WarmCache(max_entries=2)
    s1, s2, s3 = _sig(0.1), _sig(0.1, "var"), _sig(0.1, "std")
    c.insert(s1, _entry())
    c.insert(s2, _entry())
    c.lookup(s1, epsilon=0.1)
    c.insert(s3, _entry())
    assert c.evictions == 1 and len(c) == 2
    assert c.lookup(s2, epsilon=0.1) == ("miss", None)
    assert c.lookup(s1, epsilon=0.1)[0] == "exact"
    assert c.lookup(s3, epsilon=0.1)[0] == "exact"


def test_warm_cache_byte_bound():
    e = _entry()
    c = WarmCache(max_entries=100, max_bytes=3 * e.nbytes)
    for f in ("avg", "var", "std", "sum", "count"):
        c.insert(_sig(0.1, f), _entry())
    assert c.bytes_used <= c.max_bytes and c.evictions >= 2
    assert len(c) == 3
    assert e.nbytes == jwc.WarmEntry(
        beta=e.beta, n_star=e.n_star, iterations=5, epsilon=0.1,
        answer=jwc.CachedAnswer(theta=np.ones((2, 1)), error=0.05,
                                success=True, n=e.n_star.copy(),
                                epsilon=0.1)).nbytes


def test_warm_cache_exact_vs_warm_vs_fallback():
    c = WarmCache()
    c.insert(_sig(0.1), _entry(eps=0.1))
    assert c.lookup(_sig(0.1), epsilon=0.1)[0] == "exact"
    assert c.lookup(_sig(0.101), epsilon=0.101)[0] == "warm"
    kind, ce = c.lookup(_sig(0.3), epsilon=0.3)
    assert kind == "warm" and ce.epsilon == 0.1
    assert c.lookup(_sig(0.1, "var"), epsilon=0.1) == ("miss", None)
    assert (c.hits, c.exact_hits, c.warm_hits, c.misses) == (3, 1, 2, 1)


def test_warm_cache_rotate_epoch_invalidates():
    c = WarmCache()
    c.insert(c.signature(Query(func="avg", epsilon=0.1)), _entry())
    c.rotate_epoch()
    assert len(c) == 0 and c.stale == 1 and c.evictions == 0
    assert c.epoch == 1
    assert c.lookup(c.signature(Query(func="avg", epsilon=0.1)),
                    epsilon=0.1) == ("miss", None)


def test_predict_n0_exact_and_model():
    c = WarmCache()
    e = _entry(eps=0.1)
    np.testing.assert_array_equal(
        c.predict_n0(e, epsilon=0.1, n_min=300), [800, 900])
    n_tight = c.predict_n0(e, epsilon=0.05, n_min=300)
    assert np.all(n_tight >= 300)
    bad = _entry(eps=0.1)
    bad.beta = np.asarray([500.0, 1e-12, 1e-12], np.float32)
    np.testing.assert_array_equal(
        c.predict_n0(bad, epsilon=0.05, n_min=300), [800, 900])


def test_predict_n0_equal_to_reference():
    """Solo (m+1,) and grouped (G, 2) entries: the same tick-0 targets."""
    rng = np.random.default_rng(4)
    tc, jc = WarmCache(), jwc.WarmCache()
    assert WARM_MARGIN == jwc.WARM_MARGIN
    for _ in range(200):
        grouped = rng.uniform() < 0.5
        m = int(rng.integers(2, 10))
        beta = (np.stack([rng.uniform(-3, 1, m), rng.uniform(0.2, 0.8, m)], 1)
                if grouped else np.concatenate(
                    [rng.uniform(-3, 1, 1), rng.uniform(0.05, 0.8, m)]))
        beta = beta.astype(np.float32)
        n_star = rng.integers(300, 9000, m).astype(np.int64)
        eps0 = float(rng.uniform(0.01, 0.2))
        te = WarmEntry(beta=beta, n_star=n_star, iterations=4, epsilon=eps0)
        je = jwc.WarmEntry(beta=beta, n_star=n_star, iterations=4,
                           epsilon=eps0)
        for eps in (eps0, eps0 * 0.7, eps0 * 1.9):
            assert np.array_equal(tc.predict_n0(te, epsilon=eps, n_min=300),
                                  jc.predict_n0(je, epsilon=eps, n_min=300))


# ---------------------------------------------------------------------------
# Fused warm start: the contract, and the reference's trajectories
# ---------------------------------------------------------------------------

def _solo(data, eps, key, warm_n0=None, warm_beta=None, skey=SKEY):
    return tf.fused_l2miss(
        data.values, data.offsets, np.ones(data.num_groups, np.float32),
        key, eps, 0.05, sample_key=keylib.prng_key(skey), warm_n0=warm_n0,
        warm_beta=warm_beta, **FUSED)


def _jsolo(jd, eps, key, warm_n0=None, warm_beta=None):
    return jf.fused_l2miss(
        jd.values, jnp.asarray(jd.offsets),
        jnp.ones(jd.num_groups, jnp.float32), jnp.asarray(key),
        jnp.float32(eps), 0.05, sample_key=jax.random.PRNGKey(SKEY),
        warm_n0=warm_n0, warm_beta=warm_beta, **FUSED)


def test_fused_warm_start_contract(data):
    """A warm lane meets the same (epsilon, delta) contract as a cold one:
    fewer iterations when the prediction is right, the extend loop when it
    is stale or its coefficients are garbage."""
    eps, key = 0.05, keylib.prng_key(3)
    cold = _solo(data, eps, key)
    assert bool(cold.success) and not bool(cold.failed)
    assert int(cold.iterations) > 2
    warm = _solo(data, eps, key, warm_n0=cold.n.numpy(),
                 warm_beta=cold.beta.numpy())
    assert bool(warm.success) and not bool(warm.failed)
    assert float(warm.error) <= eps
    assert int(warm.iterations) < int(cold.iterations)
    assert int(warm.iterations) <= 2
    stale = _solo(data, eps, key,
                  warm_n0=np.full(data.num_groups, KW["n_min"], np.int32),
                  warm_beta=np.asarray([0.0, 0.05, 0.05], np.float32))
    assert bool(stale.success) and not bool(stale.failed)
    assert float(stale.error) <= eps
    with pytest.raises(ValueError):
        _solo(data, eps, key, warm_n0=cold.n.numpy())


def _cases(jd, seed):
    """(name, eps, warm_n0, warm_beta) warm starts of one key: the cold
    run's own state, a stale prediction with garbage coefficients, and
    Eq.-13 near-repeats at a tighter and a looser bound."""
    key = jax.random.PRNGKey(seed)
    cold = _jsolo(jd, 0.05, key)
    n, beta = np.asarray(cold.n), np.asarray(cold.beta)
    entry = WarmEntry(beta=beta, n_star=n.astype(np.int64),
                      iterations=int(cold.iterations), epsilon=0.05)
    c = WarmCache()
    return key, [
        ("right", 0.05, n, beta),
        ("stale", 0.05, np.full(2, 300, np.int32),
         np.asarray([0.0, 0.05, 0.05], np.float32)),
        ("tighter", 0.04, c.predict_n0(entry, epsilon=0.04, n_min=300), beta),
        ("looser", 0.08, c.predict_n0(entry, epsilon=0.08, n_min=300), beta),
    ]


@pytest.mark.parametrize("seed", [3, 6])
def test_fused_warm_matches_reference(pair, seed):
    jd, td = pair
    key, cases = _cases(jd, seed)
    for name, eps, wn0, wb in cases:
        rj = _jsolo(jd, eps, key, wn0, wb)
        rt = _solo(td, eps, np.asarray(key), wn0, wb)
        its = int(rj.iterations)
        assert int(rt.iterations) == its, name
        for f in ("n", "success", "failed", "rows_sampled"):
            assert np.array_equal(getattr(rt, f).numpy(),
                                  np.asarray(getattr(rj, f))), (name, f)
        assert np.array_equal(rt.profile_n.numpy()[:its],
                              np.asarray(rj.profile_n)[:its]), name
        # Tick 0 takes the prediction as it is (clipped to n_cap).
        assert np.array_equal(rt.profile_n.numpy()[0],
                              np.minimum(wn0, FUSED["n_cap"])), name
        assert_allclose(rt.theta.numpy(), np.asarray(rj.theta), rtol=1e-5)
        assert_allclose(float(rt.error), float(rj.error), rtol=1e-4)


def test_one_tick_from_converted_warm_state(pair):
    """A warm lane pool mid-run in the reference, converted (warm rows
    included), steps once in each package to the same state."""
    jd, td = pair
    q = 3
    keys = jax.random.split(jax.random.PRNGKey(5), q)
    wn0 = jnp.asarray([[900, 700], [300, 300], [2000, 1500]], jnp.int32)
    wb = jnp.asarray([[0.0, 0.5, 0.5], [0.0, 0.05, 0.05], [0.1, 0.4, 0.3]],
                     jnp.float32)
    params = jf.make_lane_params(
        jnp.asarray(jd.offsets), jnp.ones((q, 2), jnp.float32), keys,
        jnp.asarray([0.05, 0.05, 0.03], jnp.float32), jnp.full((q,), 0.05),
        jax.random.PRNGKey(8), jnp.zeros((q,), jnp.int32),
        n_cap=FUSED["n_cap"], warm=jnp.asarray([True, True, False]),
        warm_n0=wn0, warm_beta=wb)
    state = jf.init_lane_state(keys, 2, n_cap=FUSED["n_cap"], c_dim=1,
                               p_dim=1, n_min=300, max_iters=16,
                               dtype=jd.values.dtype)
    step = {k: v for k, v in FUSED.items() if k != "est_name"}
    off = jnp.asarray(jd.offsets)
    leaves = lambda nt: {f: np.asarray(getattr(nt, f)) for f in nt._fields}
    for k in range(3):
        ts = convert.lane_state_from_numpy(leaves(state), device="cpu")
        tp = convert.lane_params_from_numpy(leaves(params), device="cpu")
        assert torch.equal(tp.warm, torch.tensor([True, True, False]))
        state = jf.fused_step(jd.values, off, state, params, est_name="avg",
                              **step)
        jn = leaves(state)
        tn = tf.fused_step(td.values, td.offsets, ts, tp, est_name="avg",
                           **step)
        for f in ("k", "iters", "n_cur", "filled", "done", "failed",
                  "prof_n", "buf", "beta"):
            assert np.array_equal(getattr(tn, f).numpy(), jn[f]), (k, f)
        assert_allclose(tn.theta.numpy(), jn["theta"], rtol=1e-5)
        assert_allclose(tn.e.numpy(), jn["e"], rtol=1e-4)


# ---------------------------------------------------------------------------
# Warm lanes and blocks in the pool
# ---------------------------------------------------------------------------

def test_pool_warm_lane_equals_solo_warm_run(data):
    """A warm lane spliced beside cold traffic equals its solo warm run, bit
    for bit; a cold neighbour equals its solo cold run."""
    skey = keylib.prng_key(SKEY)
    keys = keylib.split(keylib.prng_key(9), 3)
    pool = LanePool(data, lanes=2, tiers=1, seed=0, sample_key=skey,
                    **{k: v for k, v in FUSED.items() if k != "est_name"})
    wn0, wb = np.asarray([2600, 2400]), np.asarray([-2.0, 0.4, 0.4],
                                                   np.float32)
    q0 = pool.submit(Query("avg", epsilon=0.05), key=keys[0])
    q1 = pool.submit(Query("avg", epsilon=0.05), key=keys[1], warm_n0=wn0,
                     warm_beta=wb)
    q2 = pool.submit(Query("avg", epsilon=0.06), key=keys[2], warm_n0=wn0,
                     warm_beta=wb)
    out = {r.qid: r for r in pool.drain()}
    assert pool.stats()["warm_spliced"] == 2
    assert out[q1].warm and out[q2].warm and not out[q0].warm
    for q, k, eps, w in ((q0, keys[0], 0.05, None), (q1, keys[1], 0.05, 1),
                         (q2, keys[2], 0.06, 1)):
        solo = _solo(data, eps, k, *((wn0, wb) if w else (None, None)))
        r = out[q]
        assert np.array_equal(r.n, solo.n.numpy())
        assert r.iterations == int(solo.iterations)
        assert r.theta.tobytes() == solo.theta.numpy().tobytes()
        assert r.error == float(solo.error)


def _block_inputs(td):
    G = td.num_groups
    return (np.asarray([2200, 1800]), np.asarray([[-1.5, 0.45], [-1.2, 0.5]],
                                                 np.float32), G)


def test_pool_warm_block_equals_warm_fused_grouped(data):
    wn0, wb, G = _block_inputs(data)
    skey = keylib.prng_key(SKEY)
    gkey = keylib.prng_key(17)
    pool = LanePool(data, lanes=2, seed=0, sample_key=skey,
                    **{k: v for k, v in FUSED.items() if k != "est_name"})
    qid = pool.submit_group(Query("avg", epsilon=0.05, group_by=True),
                            key=gkey, warm_n0=wn0, warm_beta=wb)
    (r,) = pool.drain()
    assert r.qid == qid and r.warm and pool.warm_spliced == 1
    want = tf.fused_grouped(data.values, data.offsets, np.ones(G), gkey,
                            0.05, 0.05, sample_key=skey, warm_n0=wn0,
                            warm_beta=wb, **FUSED)
    assert np.array_equal(r.n, want.n.numpy())
    assert np.array_equal(r.iterations, want.iterations.numpy())
    assert r.theta.tobytes() == want.theta.numpy()[:, 0].tobytes()
    assert r.error.tobytes() == want.error.numpy().tobytes()
    assert np.array_equal(want.profile_n.numpy()[:, 0], wn0)


def test_pool_warm_block_matches_reference(pair):
    jd, td = pair
    wn0, wb, G = _block_inputs(td)
    spec = {k: v for k, v in FUSED.items() if k != "est_name"}
    skey = jax.random.PRNGKey(SKEY)
    gkey = jax.random.PRNGKey(17)
    jp = JPool(jd, lanes=2, seed=0, sample_key=skey, **spec)
    tp = LanePool(td, lanes=2, seed=0, sample_key=np.asarray(skey), **spec)
    jp.submit_group(jq.Query("avg", epsilon=0.05, group_by=True), key=gkey,
                    warm_n0=wn0, warm_beta=wb)
    tp.submit_group(Query("avg", epsilon=0.05, group_by=True),
                    key=np.asarray(gkey), warm_n0=wn0, warm_beta=wb)
    (rj,), (rt,) = jp.drain(), tp.drain()
    assert rt.warm and rj.warm
    assert np.array_equal(rt.n, np.asarray(rj.n))
    assert np.array_equal(rt.iterations, np.asarray(rj.iterations))
    assert np.array_equal(rt.group_success, np.asarray(rj.group_success))
    assert rt.rows_sampled == rj.rows_sampled
    assert_allclose(rt.theta, np.asarray(rj.theta), rtol=1e-5)
    assert_allclose(rt.error, np.asarray(rj.error), rtol=1e-3)


# ---------------------------------------------------------------------------
# Session: exact replay, warm route, invalidation, stats
# ---------------------------------------------------------------------------

def _run_one(sess, query, rid):
    t = sess.submit(Request(query=query, rid=rid))
    while sess.in_flight:
        sess.pump()
    return sess.poll(t)


def _launches():
    return (pb_ops.counter.launches, seg_ops.boot_counter.launches,
            seg_ops.agg_counter.launches)


def test_session_exact_repeat_bit_equal_zero_dispatches(data):
    sess = AQPSession(data, warm_cache=True, **KW)
    q = Query(func="avg", epsilon=0.2)
    r1 = _run_one(sess, q, rid=90_001)
    d0, rows0 = sess.fused_dispatches, sess.rows_touched
    launches0 = _launches()
    pool_d0 = None if sess._pool is None else sess._pool.dispatches
    r2 = _run_one(sess, q, rid=90_002)
    assert r2.route is Route.WARM
    assert sess.fused_dispatches == d0
    assert sess.rows_touched == rows0
    assert _launches() == launches0
    assert (None if sess._pool is None else sess._pool.dispatches) == pool_d0
    assert r2.rows_sampled == 0
    assert np.array_equal(r1.theta, r2.theta)
    assert np.array_equal(r1.n, r2.n)
    assert r1.error == r2.error and r1.success == r2.success
    assert sess.cache_served == 1
    st = sess.stats()
    assert st["cache_hits"] == 1 and st["cache_misses"] == 1
    assert st["warm_cache"]["exact_hits"] == 1


def test_session_warm_hit_rides_pool_and_meets_contract(data):
    sess = AQPSession(data, warm_cache=True, **KW)
    _run_one(sess, Query(func="avg", epsilon=0.2), rid=90_101)
    r = _run_one(sess, Query(func="avg", epsilon=0.15), rid=90_102)
    assert r.route is Route.WARM
    assert r.success and r.error <= 0.15
    assert r.rows_sampled > 0
    assert sess.stats()["pool"]["warm_spliced"] == 1
    assert sess.stats()["warm_cache"]["warm_hits"] == 1
    assert sess.stats()["warm_verify_failures"] <= 1


def test_session_pinned_key_bypasses_cache(data):
    sess = AQPSession(data, warm_cache=True, **KW)
    q = Query(func="avg", epsilon=0.2)
    _run_one(sess, q, rid=90_201)
    st0 = sess.cache.stats()
    t = sess.submit(Request(query=q, rid=90_202), key=keylib.prng_key(5))
    while sess.in_flight:
        sess.pump()
    r = sess.poll(t)
    assert r.route is not Route.WARM
    st1 = sess.cache.stats()
    assert st1["hits"] == st0["hits"] and st1["misses"] == st0["misses"]
    assert st1["insertions"] == st0["insertions"]


def test_session_epoch_rotation_invalidates_cache(data):
    sess = AQPSession(data, warm_cache=True, **dict(KW, reshuffle_every=2))
    q = Query(func="avg", epsilon=0.2)
    _run_one(sess, q, rid=90_301)
    _run_one(sess, Query(func="var", epsilon=0.3), rid=90_302)
    assert sess.cache.epoch == 1 and len(sess.cache) == 0
    assert sess.cache.stats()["stale"] >= 1
    r = _run_one(sess, q, rid=90_303)
    assert r.route is not Route.WARM and r.rows_sampled > 0
    r2 = _run_one(sess, q, rid=90_304)
    assert r2.route is Route.WARM
    assert sess.cache.epoch == 1


def test_session_warm_lane_solo_parity_of_cold_requests(data):
    """With the cache on, a first-seen pooled request still equals its solo
    run, bit for bit."""
    sess = AQPSession(data, warm_cache=True,
                      planner=Planner(mode=Route.POOL, pool_lanes=2,
                                      pool_ticks_per_sync=1), **KW)
    key = keylib.prng_key(11)
    t = sess.submit(Request(query=Query(func="avg", epsilon=0.2),
                            rid=90_401), key=key)
    while sess.in_flight:
        sess.pump()
    r = sess.poll(t)
    solo = tf.fused_l2miss(
        data.values, data.offsets, np.ones(data.num_groups, np.float32), key,
        0.2, 0.05, sample_key=sess._sample_key, est_name="avg", B=KW["B"],
        n_min=KW["n_min"], n_max=KW["n_max"], l=sess._pool._spec["l"],
        max_iters=KW["max_iters"], n_cap=KW["n_cap"])
    assert np.array_equal(r.n, solo.n.numpy())
    assert r.theta.tobytes() == solo.theta.numpy().tobytes()
    assert r.error == float(solo.error)


def test_session_grouped_repeat_and_warm_block(data):
    """A GROUP BY request repeated exactly replays its per-group answer
    with no dispatch; a near-repeat runs as a warm block."""
    sess = AQPSession(data, warm_cache=True, **KW)
    q = Query(func="avg", epsilon=0.1, group_by=True)
    r1 = _run_one(sess, q, rid=90_501)
    assert r1.route is Route.POOL and r1.group_by
    d0 = sess.fused_dispatches
    r2 = _run_one(sess, q, rid=90_502)
    assert r2.route is Route.WARM and sess.fused_dispatches == d0
    assert np.array_equal(r2.group_error, r1.group_error)
    assert np.array_equal(r2.group_success, r1.group_success)
    assert np.array_equal(r2.theta, r1.theta)
    r3 = _run_one(sess, Query(func="avg", epsilon=0.09, group_by=True),
                  rid=90_503)
    assert r3.route is Route.WARM and r3.rows_sampled > 0
    assert r3.success and np.all(r3.group_error <= 0.09)
    assert sess.stats()["pool"]["warm_spliced"] == 1


def test_service_warm_cache_replays_a_batch(data):
    svc = AQPService(data, warm_cache=True, B=100, n_min=300, n_max=600,
                     max_iters=16, n_cap=1 << 13)
    qs = [Query(func="avg", epsilon=0.2), Query(func="var", epsilon=0.3)]
    a = svc.answer(qs)
    d0, rows0 = svc.session.fused_dispatches, svc.session.rows_touched
    b = svc.answer(qs)
    assert svc.session.fused_dispatches == d0
    assert svc.session.rows_touched == rows0
    for x, y in zip(a, b):
        assert np.array_equal(x.theta, y.theta) and x.error == y.error
    assert svc.session.cache_served == 2
