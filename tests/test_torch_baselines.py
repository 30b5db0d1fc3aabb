"""The port's baselines (``repro_torch.core.baselines``) and data helpers
against the reference's on the reference test's fixture
(``make_grouped(["normal", "exp"], 120_000, seed=3, biases=[4, 2])``).

The host-numpy parts draw the same rows from the same numpy streams and the
port gathers them on the device, so ``_norm_ppf``, the pilot statistics,
SPS and IFocus are bit-equal.  BLK's sizes come from those statistics
(exact); its answer is an f32 weighted mean over a stratified sample summed
in torch's order, so theta holds rtol 1e-6.  MiniBatch runs the generic
bootstrap: each trial's error holds rtol 1e-4 and theta rtol 1e-5 (ROADMAP
Queue 3 item 1's contract), and on this fixture no error lies within that
noise of epsilon, so the whole runs stop at the same trial.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.core import baselines as tbl
from repro_torch.core import estimators
from repro_torch.core import keys as keylib
from repro_torch.core import sampling as TS
from repro_torch.data import (INCONSISTENT_DISTS, INCONSISTENT_FUNCS,
                              add_group_bias, make_grouped, make_regression,
                              make_single_group)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    from repro.core import baselines as jbl
    from repro.data import make_grouped as jmake_grouped
    from repro.data import synthetic as jsyn
    from repro.data import tpch as jtpch
    return dict(bl=jbl, make_grouped=jmake_grouped, syn=jsyn, tpch=jtpch)


def _pair(jx, dists, n, seed, biases):
    return (jx["make_grouped"](dists, n, seed=seed, biases=biases),
            make_grouped(dists, n, seed=seed, biases=biases, device="cpu"))


@pytest.fixture(scope="module")
def data(jx):
    return _pair(jx, ["normal", "exp"], 120_000, 3, [4.0, 2.0])


def _same(a, b):
    """Two BaselineResults equal field by field (info compared by key)."""
    assert (a.name, a.success, a.total_sampled, a.iterations) == (
        b.name, b.success, b.total_sampled, b.iterations)
    assert np.array_equal(a.n, b.n)
    assert np.array_equal(np.asarray(a.theta), np.asarray(b.theta))
    for k, v in a.info.items():
        assert np.array_equal(np.asarray(v), np.asarray(b.info[k])), k


def test_norm_ppf_bit_equal(jx):
    ps = np.concatenate([[1e-9, 1e-4, 0.01, 0.02425, 0.025, 0.5, 0.975,
                          0.97575, 0.995, 1 - 1e-7],
                         np.random.default_rng(0).uniform(size=200)])
    for p in ps:
        assert tbl._norm_ppf(float(p)) == jx["bl"]._norm_ppf(float(p))
    assert tbl._norm_ppf(0.975) == pytest.approx(1.959964, abs=1e-4)


@pytest.mark.parametrize("pilot_n", [500, 1000, 200_000])
def test_group_pilot_stats_bit_equal(jx, data, pilot_n):
    jd, td = data
    want = jx["bl"]._group_pilot_stats(jd, np.random.default_rng(5), pilot_n)
    got = tbl._group_pilot_stats(td, np.random.default_rng(5), pilot_n)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("func", ["avg", "sum"])
def test_run_sps_bit_equal(jx, data, func):
    jd, td = data
    want = jx["bl"].run_sps(jd, func, epsilon_rel=0.05, delta=0.05, seed=2)
    got = tbl.run_sps(td, func, epsilon_rel=0.05, delta=0.05, seed=2)
    _same(want, got)
    assert got.total_sampled >= td.values.shape[0]


def test_run_ifocus_bit_equal(jx, data):
    _same(jx["bl"].run_ifocus(data[0], "avg", delta=0.05),
          tbl.run_ifocus(data[1], "avg", delta=0.05))
    jd, td = _pair(jx, ["normal", "normal", "normal"], 80_000, 5,
                   [1.0, 1.5, 2.0])
    want = jx["bl"].run_ifocus(jd, "avg", delta=0.05, seed=1)
    got = tbl.run_ifocus(td, "avg", delta=0.05, seed=1)
    _same(want, got)
    assert got.success and np.all(np.diff(got.theta.ravel()) > 0)


@pytest.mark.parametrize("func,eps", [("avg", 0.05), ("var", 0.05),
                                      ("sum", 5000.0), ("proportion", 0.05)])
def test_run_blk(jx, data, func, eps):
    jd, td = data
    want = jx["bl"].run_blk(jd, func, epsilon=eps, delta=0.05)
    got = tbl.run_blk(td, func, epsilon=eps, delta=0.05)
    assert got.success and want.success
    assert np.array_equal(got.n, want.n)
    assert got.total_sampled == want.total_sampled
    assert got.info["z"] == want.info["z"]
    assert_allclose(got.theta, np.asarray(want.theta), rtol=1e-6)


def test_run_blk_refuses_what_has_no_closed_form(data):
    res = tbl.run_blk(data[1], "median", epsilon=0.05, delta=0.05)
    assert not res.success and res.theta is None


def test_run_minibatch_against_reference(jx, data):
    """Each trial's (error, theta) on the same keys, then the whole run."""
    import jax.numpy as jnp

    jd, td = data
    step, B, delta = 400, 100, 0.05
    est = estimators.get("avg")
    key = TS.root_key(0)
    n = np.full((2,), step, np.int64)
    scale = torch.ones(2)
    errs = []
    for _ in range(4):
        key, k1 = keylib.split(key)
        n_cap = TS.bucket_cap(int(n.max()))
        fn = jx["bl"]._mb_estimate("avg", 2, n_cap, 1, B)
        ej, thj = fn(jnp.asarray(k1), jd.values, jnp.asarray(jd.offsets),
                     jnp.asarray(n), jnp.ones((2,), jnp.float32), delta)
        et, tht = tbl._mb_estimate(est, k1, td, n, n_cap, scale, delta, B)
        assert_allclose(float(et), float(ej), rtol=1e-4)
        assert_allclose(tht.numpy(), np.asarray(thj), rtol=1e-5)
        errs.append(float(ej))
        n = n + step
    assert errs[-1] < errs[0]

    for eps in (0.05, 0.03):
        want = jx["bl"].run_minibatch(jd, "avg", epsilon=eps, delta=delta,
                                      step=step, B=B)
        got = tbl.run_minibatch(td, "avg", epsilon=eps, delta=delta,
                                step=step, B=B)
        assert want.success and got.success
        assert got.iterations == want.iterations > 1
        assert np.array_equal(got.n, want.n)
        assert got.total_sampled == want.total_sampled
        assert_allclose(got.theta, np.asarray(want.theta), rtol=1e-5)
        assert got.info["error"] <= eps


def test_data_helpers_bit_equal(jx):
    syn, tpch = jx["syn"], jx["tpch"]
    assert INCONSISTENT_DISTS == syn.INCONSISTENT_DISTS
    assert INCONSISTENT_FUNCS == syn.INCONSISTENT_FUNCS
    for dist in ("exp", "pareto2"):
        a = syn.make_single_group(dist, 5000, seed=4, bias=1.5)
        b = make_single_group(dist, 5000, seed=4, bias=1.5, device="cpu")
        assert np.array_equal(np.asarray(a.values), b.values.numpy())
        assert np.array_equal(a.offsets, b.offsets)
    for logistic in (False, True):
        a = syn.make_regression(3000, 4, seed=6, logistic=logistic, groups=2)
        b = make_regression(3000, 4, seed=6, logistic=logistic, groups=2,
                            device="cpu")
        assert np.array_equal(np.asarray(a.values), b.values.numpy())
        assert np.array_equal(a.offsets, b.offsets)
    jd, td = _pair(jx, ["normal", "exp", "uniform"], 4000, 8, None)
    a = tpch.add_group_bias(jd, 0.05)
    b = add_group_bias(td, 0.05)
    assert np.array_equal(np.asarray(a.values), b.values.numpy())
    assert np.array_equal(np.asarray(a.scale), b.scale)
    assert b.device == td.device
