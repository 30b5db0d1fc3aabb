"""The port's metric extensions (MaxMiss, LpMiss, DiffMiss, NormalMiss,
OrderMiss) against the reference at the size of tests/test_core_l2miss.py's
fixtures, on both ESTIMATE routes where the estimator allows.

Whole runs follow tests/test_torch_host_parity.py's contract (integer
trajectories equal, or the first difference explained by an f32-noise
straddle); theta rtol 1e-5 (1e-4 for var/std) and error rtol 1e-4 (2e-3
for var/std) where the trajectories agree.  OrderMiss's converted bound
eps' (an f32 gap of pilot estimates) agrees within rtol 1e-5.  The NormalMiss
replicates draw ``normal``, within 4 ulps of the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import extensions as jx
from repro.core import sampling as js
from repro.core.l2miss import MissConfig as JConfig
from repro.data import make_grouped as j_make_grouped
from repro_torch.core import extensions as tx
from repro_torch.core import sampling as ts
from repro_torch.core.l2miss import MissConfig as TConfig
from repro_torch.data import make_grouped as t_make_grouped
from test_torch_host_parity import assert_trace_parity

CFG = dict(delta=0.05, B=150, n_min=400, n_max=800, l=6, seed=0, max_iters=40)
DISTS = (["normal", "exp", "uniform"], 150_000)
TABLE = dict(seed=1, biases=[5.0, 3.0, 4.2])


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


def _tols(name):
    cancels = name in ("var", "std")
    return dict(theta_rtol=1e-4 if cancels else 1e-5,
                err_rtol=2e-3 if cancels else 1e-4)


# XLA's CPU code flushes f32 subnormals to zero and torch's does not, so the
# values lie on a 1e-3 grid, where no gap / sqrt(2) is subnormal.
@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(-10 ** 6, 10 ** 6).map(lambda i: i / 1000.0),
                min_size=2, max_size=12, unique=True))
def test_order_bound_matches_bruteforce_and_reference(vals):
    t = np.asarray(vals, np.float32)
    got = float(tx.order_bound(torch.from_numpy(t)))
    assert got == float(jx.order_bound(jnp.asarray(t)))
    assert np.isclose(got, tx.order_bound_bruteforce(t), rtol=1e-5,
                      atol=1e-6)
    assert tx.order_bound_bruteforce(t) == jx.order_bound_bruteforce(t)


def test_gammas_and_metric_value_match_reference():
    for m in (1, 3, 9):
        assert tx.gamma_linf(0.3, m) == jx.gamma_linf(0.3, m)
        assert tx.gamma_diff(0.3, m) == jx.gamma_diff(0.3, m)
        for p in (1, 2, 3.5):
            assert tx.gamma_lp(0.3, m, p) == jx.gamma_lp(0.3, m, p)
    with pytest.raises(ValueError):
        tx.gamma_lp(0.3, 3, 1.5)
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=5), rng.normal(size=5)
    for name in ("l2", "linf", "l1", "diff", "order"):
        assert tx.metric_value(name, a, b) == jx.metric_value(name, a, b)
    assert tx.metric_value("order", a, a + 1.0) == 0.0


# (runner, extra args, L2 epsilon the run uses from the user's eps)
RUNS = {
    "linf": (tx.run_maxmiss, jx.run_maxmiss, {}, lambda e, m: e),
    "l1": (tx.run_lpmiss, jx.run_lpmiss, {"p": 1}, lambda e, m: e / np.sqrt(m)),
    "lp3": (tx.run_lpmiss, jx.run_lpmiss, {"p": 3}, lambda e, m: e),
    "diff": (tx.run_diffmiss, jx.run_diffmiss, {},
             lambda e, m: e / np.sqrt(2.0)),
    "normal": (tx.run_normalmiss, jx.run_normalmiss, {}, lambda e, m: e),
}


@pytest.mark.parametrize("metric,name,route,eps", [
    ("linf", "avg", "generic", 0.05), ("linf", "var", "entry", 0.1),
    ("l1", "sum", "entry", 9000.0), ("l1", "median", "generic", 0.1),
    ("lp3", "std", "generic", 0.05), ("lp3", "avg", "entry", 0.05),
    ("diff", "avg", "generic", 0.06), ("diff", "std", "entry", 0.06),
    ("normal", "avg", "generic", 0.05), ("normal", "var", "generic", 0.1)])
def test_extension_matches_reference(jdata, tdata, metric, name, route, eps):
    t_run, j_run, extra, to_l2 = RUNS[metric]
    uk = route == "entry"
    tj = j_run(jdata, name, JConfig(epsilon=eps, use_kernel=uk, **CFG),
               **extra)
    cfg = TConfig(epsilon=eps, use_kernel=uk, **CFG)
    tt = t_run(tdata, name, cfg, **extra)
    eps2 = float(to_l2(eps, 3))
    assert_trace_parity(tj, tt, cfg, tdata.sizes, l=CFG["l"], eps_j=eps2,
                        **_tols(name))


@pytest.mark.parametrize("with_store", [False, True])
@pytest.mark.parametrize("name,route", [("avg", "generic"), ("avg", "entry"),
                                        ("median", "generic")])
def test_ordermiss_matches_reference(jdata, tdata, name, route, with_store):
    uk = route == "entry"
    sj = js.SampleStore(jdata, seed=0) if with_store else None
    st_ = ts.SampleStore(tdata, seed=0) if with_store else None
    tj = jx.run_ordermiss(jdata, name, JConfig(epsilon=0.0, use_kernel=uk,
                                               **CFG), store=sj)
    cfg = TConfig(epsilon=0.0, use_kernel=uk, **CFG)
    tt = tx.run_ordermiss(tdata, name, cfg, store=st_)
    ej, et = tj.info["order_bound_eps"], tt.info["order_bound_eps"]
    np.testing.assert_allclose(et, ej, rtol=1e-5)
    np.testing.assert_allclose(tt.info["pilot_theta"], tj.info["pilot_theta"],
                               rtol=1e-5)
    how = assert_trace_parity(tj, tt, cfg, tdata.sizes, l=CFG["l"],
                              eps_j=ej, eps_t=et, **_tols(name))
    if with_store and how == "equal":
        # The pilot windows are a prefix the run re-reads, not re-draws.
        assert st_.rows_touched == sj.rows_touched
