"""The port's sharded layout and sharded fused step against the JAX reference
(tests/test_shard_parity.py mirrored on the port), on the same numpy inputs
and keys at that file's ``SPEC`` size.

* ``ShardLayout`` (alloc tables, sub-extents, capacities, the host helpers)
  and ``sharded_slot_tables`` are integer or host numpy: held EQUAL to the
  reference's, besides the reference's own invariants.
* ``_window_ladder``/``resolve_seg_window`` equal.
* The windowed ESTIMATE: the mask is exact (poisoned slots change no bit),
  inactive lanes are zeros, the sums match the direct contraction and the
  reference's within f32 order (rtol 2e-5), and -- the port's own contract --
  equal the card's prefix-rung path bit for bit.
* Sharded trajectories (solo ``fused_l2miss`` at S = 2 and 4, the
  ``mesh=False`` pool at S = 4) against the reference under the sweep
  contract of tests/test_torch_fused_sweep.py; inside the port a pool lane
  equals its solo sharded run bit for bit.

The mesh pool is held bit-equal to the ``mesh=False`` pool by 4-rank gloo
runs in tests/test_torch_mesh.py.  The reference's
``test_sharded_step_memo_is_bounded`` (tests/test_serve_warm_cache.py) has no
counterpart: nothing in the port compiles, so ``make_sharded_step`` keeps no
memo.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.aqp.query import Query as JQuery, Request as JRequest
from repro.core import bootstrap as jboot
from repro.core import fused as jf
from repro.core import sampling as js
from repro.data import make_grouped as j_make_grouped
from repro.serve import AQPSession as JSession, LanePool as JPool
from repro_torch.aqp.query import Query, Request
from repro_torch.core import bootstrap, fused, sampling
from repro_torch.core.fused import fused_l2miss
from repro_torch.data import make_grouped
from repro_torch.kernels import prng
from repro_torch.serve import AQPSession, LanePool, Route
from test_torch_host_parity import _lane, assert_fused_lane_parity

SPEC = dict(B=60, n_min=100, n_max=256, max_iters=8, n_cap=1 << 10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    args = (["normal", "exp"], 12_000)
    kw = dict(seed=3, biases=[4.0, 2.0])
    return j_make_grouped(*args, **kw), make_grouped(*args, **kw,
                                                      device="cpu")


def _skewed_offsets():
    """Four groups of uneven sizes, so group extents straddle row blocks
    unevenly and one shard holds no row of a group."""
    return np.concatenate([[0], np.cumsum([7_000, 300, 2_500, 11_203])])


# ---------------------------------------------------------------------------
# ShardLayout: the alloc-table contract
# ---------------------------------------------------------------------------

def test_shard_layout_invariants(data):
    offsets = np.asarray(data[1].offsets)
    sizes = np.diff(offsets)
    for S in (1, 2, 4):
        lay = sampling.ShardLayout.build(offsets, n_cap=SPEC["n_cap"],
                                         num_shards=S)
        alloc = lay.alloc.astype(np.int64)
        d = np.diff(alloc, axis=2)
        assert d.min() >= 0 and d.max() <= 1            # 1-Lipschitz
        tot = alloc.sum(axis=0)
        for i in range(len(sizes)):                     # exact partition
            n = np.arange(SPEC["n_cap"] + 1)
            np.testing.assert_array_equal(
                tot[i], np.minimum(n, alloc[:, i, -1].sum()))
        if S == 1:
            for i in range(len(sizes)):
                np.testing.assert_array_equal(
                    alloc[0, i], np.minimum(np.arange(SPEC["n_cap"] + 1),
                                            alloc[0, i, -1]))
        assert lay.lsizes.sum() == offsets[-1]


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("table", ["fixture", "skewed"])
def test_shard_layout_equals_reference(data, table, S):
    offsets = (np.asarray(data[1].offsets) if table == "fixture"
               else _skewed_offsets())
    n_cap = SPEC["n_cap"] if table == "fixture" else 1 << 12
    a = js.ShardLayout.build(offsets, n_cap=n_cap, num_shards=S)
    b = sampling.ShardLayout.build(offsets, n_cap=n_cap, num_shards=S)
    assert (a.num_shards, a.rows_per_shard, a.n_cap, a.seg_cap) == (
        b.num_shards, b.rows_per_shard, b.n_cap, b.seg_cap)
    for f in ("lstarts", "lsizes", "alloc", "cap_groups"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.max_shard_frac() == b.max_shard_frac()
    rng = np.random.default_rng(S)
    for _ in range(3):
        filled = rng.integers(0, n_cap + 1, size=len(offsets) - 1)
        assert np.array_equal(a.shard_rows(filled), b.shard_rows(filled))
    vals = rng.normal(size=int(offsets[-1])).astype(np.float32)
    assert np.array_equal(a.pad_values(vals), b.pad_values(vals))
    padded = b.pad_values(torch.from_numpy(vals))
    assert np.array_equal(padded.numpy(), b.pad_values(vals))
    for s in range(S):
        R = b.rows_per_shard
        assert np.array_equal(b.block_values(torch.from_numpy(vals), s).numpy(),
                              b.pad_values(vals)[s * R:(s + 1) * R])


def test_shard_layout_rejects_bad_shapes():
    off = _skewed_offsets()
    with pytest.raises(ValueError):
        sampling.ShardLayout.build(off, n_cap=1000, num_shards=3)
    with pytest.raises(ValueError):
        sampling.ShardLayout.build(off, n_cap=1024, num_shards=0)


def test_sharded_slot_tables_stay_inside_sub_extents(data):
    lay = sampling.ShardLayout.build(np.asarray(data[1].offsets),
                                     n_cap=SPEC["n_cap"], num_shards=4)
    skey = np.asarray(jax.random.PRNGKey(5))
    local = sampling.sharded_slot_tables(skey, lay, local_rows=True,
                                         device="cpu").numpy()
    glob = sampling.sharded_slot_tables(skey, lay, local_rows=False,
                                        device="cpu").numpy()
    S, m, _ = local.shape
    for s in range(S):
        for i in range(m):
            lo, sz = int(lay.lstarts[s, i]), int(lay.lsizes[s, i])
            if sz == 0:
                continue
            assert local[s, i].min() >= lo
            assert local[s, i].max() < lo + sz
    shift = (np.arange(S) * lay.rows_per_shard)[:, None, None]
    np.testing.assert_array_equal(glob, local + shift)


@pytest.mark.parametrize("local_rows", [True, False])
@pytest.mark.parametrize("S", [2, 4])
def test_sharded_slot_tables_equal_reference(S, local_rows):
    off = _skewed_offsets()
    a = js.ShardLayout.build(off, n_cap=1 << 12, num_shards=S)
    b = sampling.ShardLayout.build(off, n_cap=1 << 12, num_shards=S)
    skey = jax.random.PRNGKey(17)
    ta = np.asarray(js.sharded_slot_tables(skey, a, local_rows=local_rows))
    tb = sampling.sharded_slot_tables(np.asarray(skey), b,
                                      local_rows=local_rows, device="cpu")
    assert tb.dtype == torch.int32
    assert np.array_equal(ta, tb.numpy())


def test_window_ladder_and_seg_window():
    for cap, base in ((2048, 150), (1024, 75), (256, 256), (1000, 33)):
        ladder = fused._window_ladder(cap, base)
        assert ladder == jf._window_ladder(cap, base)
        assert ladder[-1] == cap
        assert all(a < b for a, b in zip(ladder, ladder[1:]))
        assert ladder[0] <= base
    for S in (1, 2, 4):
        w = fused.resolve_seg_window(1 << 12, 1 << 9, S)
        assert 0 < w <= (1 << 12) // S
        assert w >= -(-(1 << 9) // S)
        for n_cap, n_max, ext in ((1 << 10, 256, None), (1 << 16, 2000, None),
                                  (1 << 13, 600, 1 << 10)):
            assert fused.resolve_seg_window(n_cap, n_max, S, ext) == \
                jf.resolve_seg_window(n_cap, n_max, S, ext)
    with pytest.raises(ValueError):
        fused.resolve_seg_window(1 << 10, 256, 3)       # n_cap % S
    with pytest.raises(ValueError):
        fused.resolve_seg_window(1 << 10, 300, 4)       # n_max > cap_s


# ---------------------------------------------------------------------------
# Windowed ESTIMATE: mask exactness, gating, order
# ---------------------------------------------------------------------------

def _windowed_case(q=6, m=2, cap=128, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(q, m, cap)).astype(np.float32)
    lo = rng.integers(0, cap // 2, size=(q, m)).astype(np.int32)
    hi = (lo + rng.integers(1, cap // 2, size=(q, m))).astype(np.int32)
    seeds = rng.integers(0, 2**32, size=(q, m)).astype(np.uint32)
    return vals, lo, hi, seeds


def _t(vals, lo, hi, seeds, act):
    return (torch.from_numpy(vals), torch.from_numpy(lo), torch.from_numpy(hi),
            torch.from_numpy(seeds.astype(np.int64)),
            torch.as_tensor(np.asarray(act, bool)))


def test_windowed_sums_mask_is_exact():
    """Slots outside [lo, hi) contribute bit-zero: poisoning them with huge
    finite values changes no output bit."""
    vals, lo, hi, seeds = _windowed_case()
    act = np.ones(vals.shape[0], bool)
    M, Mp = bootstrap.windowed_lane_moment_sums(
        *_t(vals, lo, hi, seeds, act)[:4], 16, (64, 128),
        lane_active=_t(vals, lo, hi, seeds, act)[4])
    pos = np.arange(vals.shape[2])[None, None, :]
    outside = (pos < lo[..., None]) | (pos >= hi[..., None])
    poisoned = np.where(outside, np.float32(1e30), vals)
    M2, Mp2 = bootstrap.windowed_lane_moment_sums(
        *_t(poisoned, lo, hi, seeds, act)[:4], 16, (64, 128),
        lane_active=torch.as_tensor(act))
    assert M.numpy().tobytes() == M2.numpy().tobytes()
    assert Mp.numpy().tobytes() == Mp2.numpy().tobytes()


def test_windowed_sums_match_direct_reference():
    """Weights hash on absolute slot positions: the sums are the direct
    full-width contraction's, and the reference's, within f32 order."""
    vals, lo, hi, seeds = _windowed_case()
    q, m, cap = vals.shape
    B = 16
    act = np.ones(q, bool)
    v, l_, h, sd, a = _t(vals, lo, hi, seeds, act)
    M, Mp = bootstrap.windowed_lane_moment_sums(v, l_, h, sd, B,
                                                (32, 64, cap), lane_active=a)
    pos = np.arange(cap)
    mf = ((pos[None, None, :] >= lo[..., None])
          & (pos[None, None, :] < hi[..., None])).astype(np.float64)
    x = vals.astype(np.float64)
    feats = np.stack([mf, mf * x, mf * x * x], axis=-1)
    W = prng.poisson1_weights_at(
        sd[..., None, None], torch.arange(cap)[None, None, :, None],
        torch.arange(B)[None, None, None, :]).numpy().astype(np.float64)
    M_ref = np.einsum("qmnb,qmnp->qmbp", W, feats)
    assert_allclose(M.numpy(), M_ref, rtol=2e-5, atol=1e-5)
    assert_allclose(Mp.numpy(), feats.sum(axis=2), rtol=2e-5, atol=1e-5)
    Mj, Mpj = jboot.windowed_lane_moment_sums(
        jnp.asarray(vals), jnp.asarray(lo), jnp.asarray(hi),
        jnp.asarray(seeds), B, (32, 64, cap), lane_active=jnp.asarray(act))
    assert_allclose(M.numpy(), np.asarray(Mj), rtol=2e-5, atol=1e-5)
    assert_allclose(Mp.numpy(), np.asarray(Mpj), rtol=2e-5, atol=1e-5)


def test_windowed_sums_gate_inactive_lanes():
    vals, lo, hi, seeds = _windowed_case()
    act = np.asarray([True, False, True, False, False, False])
    M, Mp = bootstrap.windowed_lane_moment_sums(
        *_t(vals, lo, hi, seeds, act)[:4], 16, (64, 128),
        lane_active=torch.as_tensor(act))
    assert np.all(M.numpy()[~act] == 0.0)
    assert np.all(Mp.numpy()[~act] == 0.0)
    assert np.any(M.numpy()[act] != 0.0)


@pytest.mark.parametrize("active", ["all", "mixed", "parked-chunk"])
def test_windowed_sums_equal_prefix_rung_bitwise(active):
    """The plain windowed path (the CPU's) equals the card's prefix-rung path
    -- one shared rung, the window as a mask, the Poisson-bootstrap kernel's
    order -- bit for bit, at every rung that covers the windows, with
    windows past the first 256-slot chunk."""
    vals, lo, hi, seeds = _windowed_case(q=9, m=3, cap=1024, seed=4)
    lo = lo * 2 + 300
    hi = np.minimum(lo + (hi - lo) * 3, 1024).astype(np.int32)
    act = {"all": np.ones(9, bool),
           "mixed": np.arange(9) % 3 != 1,
           "parked-chunk": np.arange(9) >= 4}[active]
    v, l_, h, sd, a = _t(vals, lo, hi, seeds, act)
    M, Mp = bootstrap.windowed_lane_moment_sums(v, l_, h, sd, 24,
                                                (512, 768, 1024),
                                                lane_active=a)
    for width in (int(hi[act].max()), 1024):
        M2, Mp2 = bootstrap.prefix_lane_moment_sums(
            v, l_, h, sd, 24, width, lane_active=a, use_kernel=False)
        assert M.numpy().tobytes() == M2.numpy().tobytes()
        assert Mp.numpy().tobytes() == Mp2.numpy().tobytes()


# ---------------------------------------------------------------------------
# Solo sharded closed loop, pool, session
# ---------------------------------------------------------------------------

def _solo(td, eps, key, skey, S, est="avg", **over):
    from repro_torch.core import estimators
    kw = {"l": 4, **SPEC, **over}
    return fused_l2miss(
        td.values, td.offsets, np.ones(td.num_groups, np.float32), key, eps,
        0.05, sample_key=skey, est_name=None,
        est_fids=np.asarray([estimators.moment_family_index(est)]),
        data_shards=S, **kw)


def _solo_ref(jd, eps, key, skey, S, est="avg", **over):
    from repro.core import estimators as je
    kw = {"l": 4, **SPEC, **over}
    return jf.fused_l2miss(
        jd.values, jnp.asarray(jd.offsets),
        jnp.ones(jd.num_groups, jnp.float32), key, jnp.float32(eps), 0.05,
        sample_key=skey, est_name=None,
        est_fids=jnp.asarray([je.moment_family_index(est)]), data_shards=S,
        **kw)


def test_solo_sharded_closed_loop_converges(data):
    key, skey = np.asarray(jax.random.PRNGKey(2)), np.asarray(
        jax.random.PRNGKey(9))
    for S in (2, 4):
        out = _solo(data[1], 0.2, key, skey, S)
        assert bool(out.success)
        assert np.isfinite(float(out.error))
        n = out.n.numpy()
        assert np.all(n >= 1) and np.all(n <= SPEC["n_cap"])


CASES = [(2, "avg", 0.2, 2), (2, "var", 0.3, 5), (4, "avg", 0.06, 2),
         (4, "std", 0.08, 7), (4, "sum", 600.0, 3)]


@pytest.mark.parametrize("S,est,eps,k", CASES)
def test_solo_sharded_trajectory_matches_reference(data, S, est, eps, k):
    """The sweep contract: integers equal (or the first difference an f32
    straddle of a PREDICT's ceil or of the acceptance test), theta rtol
    1e-5 (1e-4 for var/std), error rtol 1e-4 (2e-3 for var/std)."""
    jd, td = data
    key, skey = jax.random.PRNGKey(k), jax.random.PRNGKey(9)
    scale = {"sum": np.asarray(td.scale, np.float32)}.get(
        est, np.ones(2, np.float32))
    rj = jf.fused_l2miss(
        jd.values, jnp.asarray(jd.offsets), jnp.asarray(scale), key,
        jnp.float32(eps), 0.05, sample_key=skey, est_name=est,
        data_shards=S, l=4, **SPEC)
    rt = fused_l2miss(td.values, td.offsets, scale, np.asarray(key), eps,
                      0.05, sample_key=np.asarray(skey), est_name=est,
                      data_shards=S, l=4, **SPEC)
    cancels = est in ("var", "std")
    assert_fused_lane_parity(
        _lane(rj), _lane(rt), eps=eps, l=4, n_cap=SPEC["n_cap"],
        ext_cap=fused.resolve_seg_window(SPEC["n_cap"], SPEC["n_max"], S)
        * S, theta_rtol=1e-4 if cancels else 1e-5,
        err_rtol=2e-3 if cancels else 1e-4)


def _drain(pool, specs, keys, qcls):
    qids = [pool.submit(qcls(func=f, epsilon=e), key=keys[i])
            for i, (f, e) in enumerate(specs)]
    res = {r.qid: r for r in pool.drain()}
    return [res[qid] for qid in qids]


POOL_SPECS = [("avg", 0.25), ("var", 0.3), ("avg", 0.08), ("std", 0.12),
              ("avg", 0.1), ("avg", 0.25)]


@pytest.fixture(scope="module")
def pools(data):
    """The 4-shard ``mesh=False`` pool of both packages on the same requests
    (4 lanes in 2 tiers: the queue refills mid-drain)."""
    jd, td = data
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(4),
                                       len(POOL_SPECS)))
    kw = dict(lanes=4, data_shards=4, mesh=False, seed=0, tiers=2, **SPEC)
    jp = JPool(jd, sample_key=jax.random.PRNGKey(9), **kw)
    tp = LanePool(td, sample_key=np.asarray(jax.random.PRNGKey(9)), **kw)
    return (_drain(jp, POOL_SPECS, keys, JQuery),
            _drain(tp, POOL_SPECS, keys, Query), keys, tp, jp)


def test_sharded_pool_matches_solo(data, pools):
    """A ``mesh=False`` pool lane equals its solo sharded ``fused_l2miss``
    run at the pool's ``l``, bit for bit."""
    _, res, keys, tp, _ = pools
    skey = np.asarray(jax.random.PRNGKey(9))
    for i, (f, e) in enumerate(POOL_SPECS):
        solo = _solo(data[1], e, keys[i], skey, 4, est=f, l=tp._spec["l"])
        r = res[i]
        assert np.array_equal(r.n, solo.n.numpy())
        assert r.iterations == int(solo.iterations)
        assert r.success == bool(solo.success)
        assert r.rows_sampled == int(solo.rows_sampled)
        assert np.float32(r.error).tobytes() == solo.error.numpy().tobytes()
        assert r.theta.tobytes() == solo.theta.numpy().tobytes()


@pytest.mark.parametrize("i", range(len(POOL_SPECS)))
def test_sharded_pool_matches_reference(data, pools, i):
    """The two packages' pools under the sweep contract, through the solo
    runs: in each package a pool lane's integers are its solo sharded run's
    (bit for bit in the port), and the two solo runs -- which carry their
    profiles -- are held to the contract."""
    jd, td = data
    rj, rt, keys, tp, jp = pools
    f, e = POOL_SPECS[i]
    skey = jax.random.PRNGKey(9)
    l = tp._spec["l"]
    sj = _solo_ref(jd, e, jnp.asarray(keys[i]), skey, 4, est=f, l=l)
    st = _solo(td, e, keys[i], np.asarray(skey), 4, est=f, l=l)
    a, b = rj[i], rt[i]
    assert np.array_equal(np.ravel(a.n), np.asarray(sj.n))
    assert a.iterations == int(sj.iterations)
    assert np.array_equal(b.n, st.n.numpy())
    assert b.iterations == int(st.iterations)
    cancels = f in ("var", "std")
    assert_fused_lane_parity(
        _lane(sj), _lane(st), eps=e, l=l, n_cap=SPEC["n_cap"],
        ext_cap=fused.resolve_seg_window(SPEC["n_cap"], SPEC["n_max"], 4) * 4,
        theta_rtol=1e-4 if cancels else 1e-5,
        err_rtol=2e-3 if cancels else 1e-4)


def test_sharded_pool_stats_and_rotation(pools, data):
    """``stats()`` reports the shard count and the per-shard rows (equal to
    the reference's where the trajectories agree; they always sum to the
    rows gathered); a rotation rebuilds the sharded tables; GROUP BY blocks
    and migration stay single-shard."""
    rj, rt, _, tp, jp = pools
    st = tp.stats()
    assert st["data_shards"] == 4 and len(st["shard_rows"]) == 4
    assert sum(st["shard_rows"]) == st["rows_gathered"]
    if all(np.array_equal(np.ravel(a.n), b.n) for a, b in zip(rj, rt)):
        assert st["shard_rows"] == jp.stats()["shard_rows"]
    assert not tp.supports_grouped(Query(func="avg", epsilon=0.1,
                                         group_by=True))
    with pytest.raises(ValueError):
        tp.submit_group(Query(func="avg", epsilon=0.1, group_by=True))
    assert not tp.migrate_enabled
    before = tp._tiers[0].params.slot_idx.clone()
    tp.set_sample_key(np.asarray(jax.random.PRNGKey(10)))
    after = tp._tiers[0].params.slot_idx
    assert after.shape == before.shape == (4, 2, SPEC["n_cap"] // 4)
    lay = tp._layout
    assert np.array_equal(after.numpy(), sampling.sharded_slot_tables(
        np.asarray(jax.random.PRNGKey(10)), lay, local_rows=False,
        device="cpu").numpy())
    assert not np.array_equal(before.numpy(), after.numpy())
    assert tp.bucket_of(100) <= lay.seg_cap


def test_sharded_fused_step_errors(data):
    """The reference's ValueErrors of the sharded step and loop."""
    td = data[1]
    lay = sampling.ShardLayout.build(td.offsets, n_cap=SPEC["n_cap"],
                                     num_shards=4)
    keys = np.stack([np.asarray(jax.random.PRNGKey(i)) for i in range(2)])
    params = fused.make_sharded_lane_params(
        lay, np.ones((2, 2), np.float32), keys, np.full(2, 0.1, np.float32),
        np.full(2, 0.05, np.float32), keys[0], local_rows=False,
        device="cpu")
    state = fused.init_lane_state(keys, 2, n_cap=SPEC["n_cap"], c_dim=1,
                                  p_dim=1, n_min=SPEC["n_min"],
                                  max_iters=SPEC["max_iters"], device="cpu")
    spec = fused.make_shard_spec(lay, device="cpu")
    kw = dict(data_shards=4, **SPEC)
    values = lay.pad_values(td.values)
    with pytest.raises(ValueError):           # no shard_spec
        fused.fused_step(values, td.offsets, state, params, **kw)
    with pytest.raises(ValueError):           # not adaptive
        fused.fused_step(values, td.offsets, state, params, spec,
                         adaptive=False, **kw)
    with pytest.raises(ValueError):           # tables of another shard count
        fused.fused_step(values, td.offsets, state,
                         params._replace(slot_idx=params.slot_idx[:2]), spec,
                         **kw)
    with pytest.raises(ValueError):           # seg_window on one shard
        fused.fused_step(values, td.offsets, state, params, seg_window=64,
                         **SPEC)
    with pytest.raises(ValueError):           # grouped blocks are 1-shard
        fused.fused_step(values, [0, 1], state, params, spec, seg_cap=64,
                         **kw)
    with pytest.raises(ValueError):           # per-lane sample keys
        fused.make_sharded_lane_params(
            lay, np.ones((2, 2), np.float32), keys,
            np.full(2, 0.1, np.float32), np.full(2, 0.05, np.float32), keys,
            local_rows=False, device="cpu")
    with pytest.raises(ValueError):           # q > 1 without a sample key
        fused.fused_l2miss_lanes(
            td.values, td.offsets, np.ones((2, 2), np.float32), keys,
            np.full(2, 0.1, np.float32), np.full(2, 0.05, np.float32),
            data_shards=4, **SPEC)
    with pytest.raises(ValueError):           # warm rows, closed sharded loop
        fused.fused_l2miss(td.values, td.offsets, np.ones(2, np.float32),
                           keys[0], 0.1, 0.05, warm_n0=np.full(2, 200),
                           warm_beta=np.ones(3), data_shards=4, **SPEC)
    # The step itself runs: one tick from a fresh state moves every lane.
    out = fused.fused_step(values, td.offsets, state, params, spec, **kw)
    assert out.k.tolist() == [1, 1] and bool((out.filled > 0).all())


def test_sharded_session_falls_back_to_host():
    """tests/test_serve_groupby.py's sharded session on the port: a GROUP BY
    request of a sharded session takes the HOST route, in both packages,
    with the same per-group verdicts."""
    G = 6
    rng = np.random.default_rng(11)
    sizes = rng.integers(2_000, 6_000, size=G)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    mu = np.sort(rng.uniform(0, 10, size=G))
    vals = np.concatenate([rng.normal(mu[g], 1.0, size=sizes[g])
                           for g in range(G)]).astype(np.float32)
    spec = dict(B=64, n_min=200, n_max=400, max_iters=16, n_cap=1 << 12)
    from repro.core.sampling import GroupedData as JGroupedData
    from repro_torch.core.sampling import GroupedData
    jsess = JSession(JGroupedData(jnp.asarray(vals)[:, None],
                                  jnp.asarray(offsets)),
                     data_shards=2, seed=0, **spec)
    tsess = AQPSession(GroupedData(torch.from_numpy(vals), offsets,
                                   device="cpu"),
                       data_shards=2, seed=0, **spec)
    jsess.submit(JRequest(query=JQuery(func="avg", epsilon=0.25,
                                       group_by=True)))
    tsess.submit(Request(query=Query(func="avg", epsilon=0.25,
                                     group_by=True)))
    (a,), (b,) = jsess.drain(), tsess.drain()
    assert b.route is Route.HOST and b.group_by and b.success
    assert b.theta.shape == (G,)
    assert b.group_success.all()
    assert np.array_equal(np.asarray(a.group_success), b.group_success)
    assert tsess.planner.data_shards == 2


def test_prediction_growth_clamp_departs_from_reference(data):
    """A known fault of the reference, not ported: its sharded growth clamp
    bounds a PREDICTION tick's size (a prefix [0, n)) by one tick's growth,
    so at n_cap = 4096 and S = 4 every prediction stalls at 320 rows, below
    the watermark the init probes left, and the lane runs out of ticks.  The
    port bounds the prediction by the watermark plus the growth: the init
    probes are identical, and the lane grows past them and converges."""
    jd, td = data
    spec = {**SPEC, "n_cap": 1 << 12}
    rj = jf.fused_l2miss(jd.values, jnp.asarray(jd.offsets),
                         jnp.ones(2, jnp.float32), jax.random.PRNGKey(3),
                         jnp.float32(0.08), 0.05,
                         sample_key=jax.random.PRNGKey(9), est_name="avg",
                         data_shards=4, l=4, **spec)
    rt = fused_l2miss(td.values, td.offsets, np.ones(2, np.float32),
                      np.asarray(jax.random.PRNGKey(3)), 0.08, 0.05,
                      sample_key=np.asarray(jax.random.PRNGKey(9)),
                      est_name="avg", data_shards=4, l=4, **spec)
    pj, pt = np.asarray(rj.profile_n), rt.profile_n.numpy()
    assert np.array_equal(pj[:4], pt[:4])                 # the init probes
    assert_allclose(rt.profile_e.numpy()[:4], np.asarray(rj.profile_e)[:4],
                    rtol=1e-4)
    watermark = pj[:4].sum(axis=0)                        # stacked probes
    assert np.all(pj[4:] == 320) and np.all(watermark > 320)
    assert not bool(rj.success)
    assert bool(rt.success) and float(rt.error) <= 0.08
    assert np.all(pt[4] > 320)

