"""The port's grouped lane blocks against the JAX reference, at the size of
test_core_fused_grouped.py's SPEC: the stratified slot tables and ladders,
the packed-stream moment sums, one block tick from a converted mid-run
state, whole ``fused_grouped`` runs, and, inside the port, a block lane
equal bit for bit to its solo ``fused_l2miss`` run on the group's slice.

Tolerances (the reference's stated grouped tolerance): trajectory integers
(n, iterations, success, rows_sampled) exact; theta rtol 1e-5; error rtol
1e-3.  Integer tables are bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import bootstrap as jboot
from repro.core import fused as jf
from repro.core import sampling as js
from repro_torch import convert
from repro_torch.core import bootstrap as tboot
from repro_torch.core import fused as tf
from repro_torch.core import keys as keylib
from repro_torch.core import sampling as ts


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per test worker keeps
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SPEC = dict(B=64, n_min=100, n_max=200, l=4, max_iters=12, n_cap=1 << 11,
            ext_cap=1 << 9)
DELTA = 0.05


def _make(G, seed, sizes=None):
    rng = np.random.default_rng(seed)
    if sizes is None:
        sizes = rng.integers(400, 3000, size=G)
    sizes = np.asarray(sizes)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    vals = np.empty((int(offsets[-1]), 1), np.float32)
    for g in range(len(sizes)):
        vals[offsets[g]:offsets[g + 1], 0] = rng.normal(
            rng.normal(5.0, 2.0), rng.uniform(0.5, 1.5), size=sizes[g])
    return vals, offsets


# (G, data seed, key, estimator, epsilon): a uniform bound over 8 groups of
# uneven sizes, and per-group bounds on SUM (population-scaled) over 4 equal
# groups.  Both finish through the mean; a variance finish subtracts mean^2
# (~100x the variance on these tables) and loses two digits to f32 order.
CASES = {
    "avg": (8, 0, 42, "avg", 0.1),
    "sum_rows": (4, 9, 1, "sum",
                 np.asarray([300.0, 800.0, 300.0, 800.0], np.float32)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    G, seed, k, est, eps = CASES[request.param]
    vals, offsets = _make(G, seed, None if G == 8 else np.full(G, 2000))
    scale = (np.diff(offsets).astype(np.float32) if est == "sum"
             else np.ones(G, np.float32))
    key = jax.random.PRNGKey(k)
    rj = jax.tree.map(np.asarray, jf.fused_grouped(
        jnp.asarray(vals), jnp.asarray(offsets), scale, key, eps, DELTA,
        est_name=est, **SPEC))
    rt = tf.fused_grouped(torch.from_numpy(vals), offsets, scale,
                          np.asarray(key), eps, DELTA, est_name=est, **SPEC)
    return dict(vals=vals, offsets=offsets, scale=scale, key=np.asarray(key),
                est=est, eps=eps, rj=rj, rt=rt)


@pytest.mark.parametrize("n_cap", [1 << 11, 1 << 13])
def test_stratified_tables_and_keys_bit_equal(n_cap):
    _, offsets = _make(6, 3)
    key = jax.random.PRNGKey(17)
    want = np.asarray(js.stratified_slot_tables(key, jnp.asarray(offsets),
                                                n_cap))
    got = ts.stratified_slot_tables(np.asarray(key), offsets, n_cap,
                                    device="cpu")
    assert got.shape == (6, 1, n_cap) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    for g in range(6):
        assert np.array_equal(ts.stratum_key(np.asarray(key), g),
                              np.asarray(js.stratum_key(key, g)))


def test_ladders_and_seg_cap_match():
    off = np.array([0, 100, 5000, 5600], np.int64)
    for n_cap in (1 << 11, 1 << 16):
        cap = tf.grouped_seg_cap(off, n_cap)
        assert cap == jf.grouped_seg_cap(off, n_cap)
        for n_max in (200, 2000):
            assert tf.seg_ladder(cap, n_max) == jf.seg_ladder(cap, n_max)
    for cap, base in ((589824, 2048), (3000, 256), (100, 256)):
        assert tf._window_ladder(cap, base) == jf._window_ladder(cap, base)


def test_segment_moment_sums_match_reference():
    """The packed-stream sums against the reference's jnp segment path: M
    at rtol 1e-5 (atol 1e-4 near zero), M_plain at rtol 1e-6."""
    rng = np.random.default_rng(5)
    q, n, B = 5, 3000, 64
    lo = rng.integers(0, 1000, q)
    hi = lo + rng.integers(0, 1500, q)
    gid = np.concatenate([np.full(h - l, g) for g, (l, h)
                          in enumerate(zip(lo, hi))]).astype(np.int32)
    slot = np.concatenate([np.arange(l, h) for l, h in zip(lo, hi)])
    x = (rng.standard_normal(len(gid)) * 2 + 4).astype(np.float32)
    valid = np.ones(len(gid), bool)
    seeds = rng.integers(0, 2**32, q, dtype=np.uint64).astype(np.uint32)
    Mj, Pj = jboot.segment_moment_sums(
        jnp.asarray(x), jnp.asarray(gid), jnp.asarray(slot.astype(np.int32)),
        jnp.asarray(valid), jnp.asarray(seeds), q, B)
    Mt, Pt = tboot.segment_moment_sums(
        torch.from_numpy(x), torch.from_numpy(gid), torch.from_numpy(slot),
        torch.from_numpy(valid), torch.from_numpy(seeds.astype(np.int64)),
        q, B, use_kernel=False, n_slots=int(hi.max()))
    assert Mt.shape == (q, B, 3) and Pt.shape == (q, 3)
    assert_allclose(Mt.numpy(), np.asarray(Mj), rtol=1e-5, atol=1e-4)
    assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-6)


def _leaves(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


@pytest.mark.parametrize("k", [0, 3])
def test_one_block_tick_from_converted_state(k):
    """Run the reference's grouped step k ticks, convert its state, then
    step once in each package: the packed gather fills the same buffer,
    and every integer leaf agrees."""
    vals, offsets = _make(6, 2)
    G = 6
    keys = jax.vmap(lambda g: jax.random.fold_in(jax.random.PRNGKey(3), g))(
        jnp.arange(G))
    eps = jnp.full((G,), 0.08, jnp.float32)
    params = jf.make_group_lane_params(
        jnp.asarray(offsets), jnp.ones(G), keys, eps,
        jnp.full((G,), DELTA, jnp.float32), jax.random.PRNGKey(8),
        n_cap=SPEC["n_cap"])
    state = jf.init_lane_state(keys, 1, n_cap=SPEC["n_cap"], c_dim=1,
                               p_dim=1, n_min=SPEC["n_min"],
                               max_iters=SPEC["max_iters"])
    seg_cap = jf.grouped_seg_cap(offsets, SPEC["n_cap"])
    joff = jnp.asarray([0, vals.shape[0]], jnp.int32)
    for _ in range(k):
        state = jf.fused_step(jnp.asarray(vals), joff, state, params,
                              est_name="avg", seg_cap=seg_cap, **SPEC)
    ts_ = convert.lane_state_from_numpy(_leaves(state), device="cpu")
    tp = convert.lane_params_from_numpy(_leaves(params), device="cpu")
    jn = _leaves(jf.fused_step(jnp.asarray(vals), joff, state, params,
                               est_name="avg", seg_cap=seg_cap, **SPEC))
    tn = tf.fused_step(torch.from_numpy(vals), [0, vals.shape[0]], ts_, tp,
                       est_name="avg", seg_cap=seg_cap, **SPEC)
    for f in ("k", "iters", "n_cur", "filled", "done", "failed", "prof_n",
              "buf"):
        assert np.array_equal(getattr(tn, f).numpy(), jn[f]), (k, f)
    assert_allclose(tn.theta.numpy(), jn["theta"], rtol=1e-5)
    assert_allclose(tn.e.numpy(), jn["e"], rtol=1e-3)


def test_fused_grouped_matches_reference(case):
    rt, rj = case["rt"], case["rj"]
    G = len(case["offsets"]) - 1
    assert rt.n.shape == (G,) and rt.theta.shape == (G, 1)
    assert rt.profile_n.shape == (G, SPEC["max_iters"])
    assert int(rt.success.sum()) >= G - 1
    for f in ("n", "iterations", "success", "failed", "rows_sampled",
              "profile_n"):
        assert np.array_equal(getattr(rt, f).numpy(), getattr(rj, f)), f
    assert_allclose(rt.theta.numpy(), rj.theta, rtol=1e-5)
    assert_allclose(rt.error.numpy(), rj.error, rtol=1e-3)
    ok = rt.success.numpy()
    assert (rt.error.numpy()[ok] <= np.broadcast_to(case["eps"], (G,))[ok]).all()


def test_block_lane_equals_solo_run_bit_exact(case):
    """Lane g of the block equals a solo run over group g's slice with key
    fold_in(key, g) and sample key stratum_key(key, g), in every bit: the
    segment pass adds in the solo kernel's order."""
    rt, offsets, key = case["rt"], case["offsets"], case["key"]
    vals = torch.from_numpy(case["vals"])
    eps = np.broadcast_to(case["eps"], (len(offsets) - 1,))
    for g in range(len(offsets) - 1):
        size = int(offsets[g + 1] - offsets[g])
        solo = tf.fused_l2miss(
            vals[offsets[g]:offsets[g + 1]], [0, size], case["scale"][g:g + 1],
            keylib.fold_in(key, g), float(eps[g]), DELTA,
            sample_key=ts.stratum_key(key, g),
            est_name=case["est"], **SPEC)
        for f in ("error", "iterations", "success", "rows_sampled", "r2",
                  "beta", "profile_e"):
            assert torch.equal(getattr(rt, f)[g], getattr(solo, f)), (g, f)
        assert torch.equal(rt.n[g], solo.n[0]) and torch.equal(
            rt.theta[g], solo.theta[0]), g


def test_block_step_checks_its_arguments():
    vals, offsets = _make(3, 1)
    G = 3
    keys = np.stack([keylib.fold_in(keylib.prng_key(1), g)
                     for g in range(G)])
    params = tf.make_group_lane_params(
        offsets, np.ones(G), keys, np.full(G, 0.1), np.full(G, DELTA),
        keylib.prng_key(2), n_cap=SPEC["n_cap"], device="cpu")
    state = tf.init_lane_state(keys, 1, n_cap=SPEC["n_cap"], c_dim=1,
                               p_dim=1, n_min=100, max_iters=12,
                               device="cpu")
    v = torch.from_numpy(vals)
    cap = tf.grouped_seg_cap(offsets, SPEC["n_cap"])
    with pytest.raises(ValueError):
        tf.fused_step(v, offsets, state, params, seg_cap=cap, **SPEC)
    with pytest.raises(ValueError):
        tf.fused_step(v, [0, len(vals)], state, params, seg_cap=cap,
                      adaptive=False, **SPEC)
    with pytest.raises(KeyError):
        tf.fused_step(v, [0, len(vals)], state, params, seg_cap=cap,
                      est_name="no_such_estimator", **SPEC)
    with pytest.raises(ValueError):     # registered, no moments fast path
        tf.fused_step(v, [0, len(vals)], state, params, seg_cap=cap,
                      est_name="median", **SPEC)
    with pytest.raises(ValueError):
        tf.make_group_lane_params(offsets, np.ones(2), keys[:2],
                                  np.full(2, 0.1), np.full(2, DELTA),
                                  keylib.prng_key(2), n_cap=64,
                                  device="cpu")
