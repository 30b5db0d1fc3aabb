"""The port's fused L2Miss loop against the JAX reference at the size of
test_core_fused_buckets.py's KW: whole runs, a one-tick comparison from a
converted mid-run state, and the port's own bit-exact invariants (bucketed ==
full width, n_cap invariance, gated == ungated gather, step == closed loop).

Tolerances: integer trajectories (n, iterations, success, failed,
rows_sampled, filled) are exact; theta within rtol 1e-5, error/beta/r2
within rtol 1e-4 (XLA and torch sum f32 in different orders).  beta is held
norm-wise per lane (``|b_t - b_j| <= 1e-4 |b_j|``): it solves f32 normal
equations whose condition number reaches ~1e4, so each package's small
coefficients carry absolute errors near 1e-4 of the vector's norm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import fused as jf
from repro.data import make_grouped as j_make_grouped
from repro_torch import convert
from repro_torch.core import fused as tf
from repro_torch.data import make_grouped as t_make_grouped


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per test worker keeps
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


KW = dict(est_name="avg", B=100, n_min=300, n_max=600, l=6, max_iters=16,
          n_cap=1 << 13, ext_cap=1 << 10)


@pytest.fixture(scope="module")
def jdata():
    return j_make_grouped(["normal", "exp"], 60_000, seed=1, biases=[5.0, 3.0])


@pytest.fixture(scope="module")
def tdata():
    return t_make_grouped(["normal", "exp"], 60_000, seed=1,
                          biases=[5.0, 3.0], device="cpu")


def _run_t(tdata, *, key=3, eps=0.1, **over):
    return tf.fused_l2miss(
        tdata.values, tdata.offsets, np.ones(2, np.float32),
        convert.key_from_numpy(np.asarray(jax.random.PRNGKey(key))), eps,
        0.05, **{**KW, **over})


def _assert_beta_close(bt, bj):
    """Norm-wise rtol 1e-4 per lane (see the module docstring)."""
    bt, bj = np.atleast_2d(bt), np.atleast_2d(bj)
    dev = np.linalg.norm(bt - bj, axis=-1)
    assert np.all(dev <= 1e-4 * np.linalg.norm(bj, axis=-1)), (bt, bj)


def _assert_result_parity(rt, rj):
    assert np.array_equal(rt.n.numpy(), np.asarray(rj.n))
    assert int(rt.iterations) == int(rj.iterations)
    assert bool(rt.success) == bool(rj.success)
    assert bool(rt.failed) == bool(rj.failed)
    assert int(rt.rows_sampled) == int(rj.rows_sampled)
    assert np.array_equal(rt.profile_n.numpy(), np.asarray(rj.profile_n))
    assert_allclose(rt.theta.numpy(), np.asarray(rj.theta), rtol=1e-5)
    assert_allclose(float(rt.error), float(rj.error), rtol=1e-4)
    _assert_beta_close(rt.beta.numpy(), np.asarray(rj.beta))
    assert_allclose(float(rt.r2), float(rj.r2), rtol=1e-4, atol=1e-6)


def test_tables_and_keys_carry_over(jdata, tdata):
    """The same seed builds the same table in both packages, and the
    reference's table and keys convert to the port's unchanged."""
    conv = convert.grouped_data_from_numpy(
        np.asarray(jdata.values), jdata.offsets, jdata.scale, device="cpu")
    for d in (tdata, conv):
        assert np.array_equal(d.values.numpy(), np.asarray(jdata.values))
        assert np.array_equal(d.offsets, jdata.offsets)
        assert np.array_equal(d.scale, jdata.scale)
    key = convert.key_from_numpy(np.asarray(jax.random.PRNGKey(3)))
    assert key.dtype == np.uint32 and np.array_equal(
        key, np.asarray(jax.random.PRNGKey(3)))


@pytest.mark.parametrize("est,key,eps", [("avg", 3, 0.1), ("avg", 4, 0.05),
                                         ("var", 3, 0.1)])
def test_fused_l2miss_matches_reference(jdata, tdata, est, key, eps):
    rj = jf.fused_l2miss(
        jdata.values, jnp.asarray(jdata.offsets), jnp.ones(2, jnp.float32),
        jax.random.PRNGKey(key), jnp.float32(eps), 0.05,
        **{**KW, "est_name": est})
    rt = _run_t(tdata, key=key, eps=eps, est_name=est)
    assert bool(rt.success)
    _assert_result_parity(rt, rj)


def _jax_pool_setup(jdata):
    q = 3
    keys = jax.random.split(jax.random.PRNGKey(5), q)
    eps = jnp.asarray([0.15, 0.06, 0.25], jnp.float32)
    deltas = jnp.asarray([0.05, 0.05, 0.1], jnp.float32)
    fids = jnp.asarray([0, 2, 3], jnp.int32)            # avg, var, std
    params = jf.make_lane_params(
        jnp.asarray(jdata.offsets), jnp.ones((q, 2), jnp.float32), keys, eps,
        deltas, jax.random.PRNGKey(8), fids, n_cap=KW["n_cap"])
    state = jf.init_lane_state(keys, 2, n_cap=KW["n_cap"], c_dim=1, p_dim=1,
                               n_min=KW["n_min"], max_iters=KW["max_iters"],
                               dtype=jdata.values.dtype)
    return state, params


_STEP = {k: v for k, v in KW.items() if k != "est_name"}


def _leaves(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


@pytest.mark.parametrize("k", [0, 2, 5, 8])
def test_one_tick_from_converted_state(jdata, tdata, k):
    """Run the reference ``fused_step`` k ticks, convert its state, then
    step once in each package: every leaf but ``keys`` must agree."""
    state, params = _jax_pool_setup(jdata)
    offsets = jnp.asarray(jdata.offsets)
    for _ in range(k):
        state = jf.fused_step(jdata.values, offsets, state, params,
                              est_name=None, **_STEP)
    ts = convert.lane_state_from_numpy(_leaves(state), device="cpu")
    tp = convert.lane_params_from_numpy(_leaves(params), device="cpu")
    jn = _leaves(jf.fused_step(jdata.values, offsets, state, params,
                               est_name=None, **_STEP))
    tn = tf.fused_step(tdata.values, tdata.offsets, ts, tp, est_name=None,
                       **_STEP)
    for f in ("k", "iters", "n_cur", "filled", "done", "failed", "prof_n",
              "buf"):
        assert np.array_equal(getattr(tn, f).numpy(), jn[f]), (k, f)
    assert_allclose(tn.theta.numpy(), jn["theta"], rtol=1e-5)
    assert_allclose(tn.e.numpy(), jn["e"], rtol=1e-4)
    assert_allclose(tn.prof_loge.numpy(), jn["prof_loge"], atol=1e-4)
    _assert_beta_close(tn.beta.numpy(), jn["beta"])
    assert_allclose(tn.r2.numpy(), jn["r2"], rtol=1e-4, atol=1e-6)


def test_bucketed_matches_fullwidth_bit_exact(tdata):
    """Bucketing is compute width only: with the fixed summation order the
    port's bucketed and full-width runs agree in every bit."""
    r_b = _run_t(tdata, adaptive=True)
    r_f = _run_t(tdata, adaptive=False)
    assert bool(r_b.success)
    for a, b in zip(r_b, r_f):
        assert torch.equal(a, b)


def test_ncap_invariance_bit_exact(tdata):
    r_small = _run_t(tdata, eps=0.15, n_cap=1 << 12)
    r_large = _run_t(tdata, eps=0.15, n_cap=1 << 13)
    assert bool(r_small.success)
    for f in ("n", "error", "theta", "iterations", "rows_sampled", "beta",
              "r2"):
        assert torch.equal(getattr(r_small, f), getattr(r_large, f)), f


def test_gated_gather_bit_exact(tdata):
    r_g = _run_t(tdata, eps=0.08, gate_gather=True)
    r_u = _run_t(tdata, eps=0.08, gate_gather=False)
    assert bool(r_g.success)
    for a, b in zip(r_g, r_u):
        assert torch.equal(a, b)


def test_step_matches_closed_loop(tdata):
    """Host-ticked ``fused_step`` and the closed loop run the same body."""
    q = 3
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(1), q))
    eps = np.asarray([0.15, 0.08, 0.2], np.float32)
    deltas = np.full((q,), 0.05, np.float32)
    skey = np.asarray(jax.random.PRNGKey(7))
    scale = np.ones((q, 2), np.float32)
    r_loop = tf.fused_l2miss_lanes(tdata.values, tdata.offsets, scale, keys,
                                   eps, deltas, skey, **KW)
    params = tf.make_lane_params(tdata.offsets, scale, keys, eps, deltas,
                                 skey, n_cap=KW["n_cap"], device="cpu")
    state = tf.init_lane_state(keys, 2, n_cap=KW["n_cap"], c_dim=1, p_dim=1,
                               n_min=KW["n_min"], max_iters=KW["max_iters"],
                               device="cpu")
    while bool(tf.lane_active(state, KW["max_iters"]).any()):
        state = tf.fused_step(tdata.values, tdata.offsets, state, params,
                              **KW)
    for a, b in zip(r_loop, tf.lanes_result(state)):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError):
        tf.fused_l2miss_batch(tdata.values[None], tdata.offsets, scale[:1],
                              keys[:1], eps[:1], 0.05)
