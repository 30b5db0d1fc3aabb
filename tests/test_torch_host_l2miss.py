"""The port's host-route L2Miss against the reference at the size of
tests/test_core_l2miss.py's fixtures: the SampleStore (permutations, rows,
costs bit-equal), every estimator's ``evaluate`` and bootstrap
``replicates``, the generic ESTIMATE, the moments entry (the port's plain
version against the reference's kernel in interpret mode), and whole
``run_l2miss`` runs on both ESTIMATE routes.

Tolerances (f32 sums run in different orders): quantile, min and max
replicates and answers are exact (integer cumulative weights, the same
stable sort); moment answers rtol 1e-5, replicates and errors rtol 1e-4
(2e-3 for var/std, whose finish cancels: E[x^2] - mu^2); linreg rtol
1e-4 and logreg rtol 1e-3 (twelve f32 Newton solves).  Whole runs follow
tests/test_torch_host_parity.py's contract: integer trajectories equal, or the
first difference explained by an f32-noise straddle of a ``ceil`` or of
the acceptance test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bootstrap as jb
from repro.core import estimators as je
from repro.core import sampling as js
from repro.core.l2miss import MissConfig as JConfig
from repro.core.l2miss import exact_answer as j_exact
from repro.core.l2miss import run_l2miss as j_run
from repro.data import make_grouped as j_make_grouped
from repro.kernels.poisson_bootstrap import ops as j_pb
from repro_torch.core import bootstrap as tb
from repro_torch.core import estimators as te
from repro_torch.core import sampling as ts
from repro_torch.core.l2miss import MissConfig as TConfig
from repro_torch.core.l2miss import exact_answer as t_exact
from repro_torch.core.l2miss import moments_entry
from repro_torch.core.l2miss import run_l2miss as t_run
from repro_torch.data import make_grouped as t_make_grouped
from repro_torch.kernels import resolve_use_kernel
from repro_torch.kernels.poisson_bootstrap import ops as t_pb
from test_torch_host_parity import assert_trace_parity

CFG = dict(delta=0.05, B=150, n_min=400, n_max=800, l=6, seed=0, max_iters=40)
ALL_EST = ["avg", "proportion", "var", "std", "sum", "count", "median",
           "maxq", "minq", "max", "min", "linreg", "logreg"]
CANCELS = ("var", "std")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jdata():
    return j_make_grouped(["normal", "exp"], 150_000, seed=1,
                          biases=[5.0, 3.0])


@pytest.fixture(scope="module")
def tdata():
    return t_make_grouped(["normal", "exp"], 150_000, seed=1,
                          biases=[5.0, 3.0], device="cpu")


def _two_col(n=600, seed=0):
    """(n, 2) rows [x, y] with y a noisy linear function of x, a mask, and
    the same with y = 1[x + noise > 0] for logreg."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    y = (1.5 * x + 0.3 + 0.5 * rng.normal(size=n)).astype(np.float32)
    yb = (x + 0.7 * rng.normal(size=n) > 0).astype(np.float32)
    mask = (np.arange(n) < n - 50).astype(np.float32)
    return np.stack([x, y], 1), np.stack([x, yb], 1), mask


def _input(name):
    xy, xb, mask = _two_col()
    return (xb if name == "logreg" else xy), mask


def _rtol(name):
    return {"linreg": 1e-4, "logreg": 1e-3}.get(
        name, 2e-3 if name in CANCELS else 1e-4)


def test_registry_order_matches_reference():
    assert [e.name for e in te.REGISTRY_BY_ID] == [
        e.name for e in je.REGISTRY_BY_ID]
    for e in te.REGISTRY_BY_ID:
        j = je.get(e.name)
        assert (e.eid, e.needs_population_scale, e.bootstrap_consistent,
                e.moments_finish is None, e.out_dim(2)) == (
            j.eid, j.needs_population_scale, j.bootstrap_consistent,
            j.moments_finish is None, j.out_dim(2))


@pytest.mark.parametrize("name", ALL_EST)
def test_evaluate_matches_reference(name):
    x, mask = _input(name)
    want = np.asarray(je.evaluate(je.get(name), jnp.asarray(x),
                                  jnp.asarray(mask)))
    got = te.evaluate(te.get(name), torch.from_numpy(x),
                      torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape
    if name in ("median", "maxq", "minq", "max", "min"):
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=_rtol(name) / 10,
                                   atol=1e-6)


@pytest.mark.parametrize("backend", ["poisson", "multinomial", "normal"])
@pytest.mark.parametrize("name", ALL_EST)
def test_replicates_match_reference(name, backend):
    if backend == "normal" and name not in jb._NORMAL_OK:
        with pytest.raises(ValueError):
            tb.replicates(te.get(name), torch.zeros(8), torch.ones(8),
                          np.zeros(2, np.uint32), 4, "normal")
        return
    x, mask = _input(name)
    k = jax.random.PRNGKey(17)
    want = np.asarray(jb.replicates(je.get(name), jnp.asarray(x),
                                    jnp.asarray(mask), k, 64, backend))
    got = tb.replicates(te.get(name), torch.from_numpy(x),
                        torch.from_numpy(mask), np.asarray(k), 64,
                        backend).numpy()
    assert got.shape == want.shape
    if name in ("median", "maxq", "minq", "max", "min"):
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=_rtol(name), atol=1e-5)


def _stratified(jdata, tdata, n_vec, seed=2):
    k = jax.random.PRNGKey(seed)
    cap = js.bucket_cap(int(max(n_vec)))
    sj, mj = js.stratified_sample(k, jdata.values, jnp.asarray(jdata.offsets),
                                  jnp.asarray(n_vec), cap)
    st, mt = ts.stratified_sample(np.asarray(k), tdata.values,
                                  tdata.offsets, n_vec, cap)
    assert np.array_equal(st.numpy(), np.asarray(sj))
    return (sj, mj), (st, mt)


@pytest.mark.parametrize("name,metric", [
    ("avg", "l2"), ("sum", "linf"), ("var", "l1"), ("std", "l2"),
    ("median", "l2"), ("maxq", "linf"), ("min", "l1")])
def test_estimate_error_generic_matches_reference(jdata, tdata, name, metric):
    (sj, mj), (st, mt) = _stratified(jdata, tdata, [700, 1000])
    scale = np.asarray(jdata.scale if je.get(name).needs_population_scale
                       else np.ones(2), np.float32)
    k = jax.random.PRNGKey(23)
    ej, thj = jb.estimate_error(je.get(name), sj, mj, jnp.asarray(scale), k,
                                0.05, B=150, metric=metric)
    et, tht = tb.estimate_error(te.get(name), st, mt,
                                torch.from_numpy(scale), np.asarray(k), 0.05,
                                B=150, metric=metric)
    exact = name in ("median", "maxq", "min")
    rt = 0.0 if exact else _rtol(name)
    np.testing.assert_allclose(float(et), float(ej), rtol=rt)
    np.testing.assert_allclose(tht.numpy(), np.asarray(thj),
                               rtol=rt / 10 if rt else 0.0)
    pj = jb.per_group_errors(je.get(name), sj, mj, jnp.asarray(scale), k,
                             0.05, B=150)
    pt = tb.per_group_errors(te.get(name), st, mt, torch.from_numpy(scale),
                             np.asarray(k), 0.05, B=150)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=rt)


@pytest.mark.parametrize("name,metric", [
    ("avg", "l2"), ("sum", "l2"), ("var", "linf"), ("std", "l1"),
    ("count", "l2")])
def test_moments_entry_matches_interpret_kernel(jdata, tdata, name, metric):
    """The port's moments entry on CPU tensors (the kernel's plain version)
    against the reference's entry with its kernel in interpret mode."""
    (sj, mj), (st, mt) = _stratified(jdata, tdata, [500, 900], seed=4)
    scale = np.asarray(jdata.scale if je.get(name).needs_population_scale
                       else np.ones(2), np.float32)
    k = jax.random.PRNGKey(31)
    ej, thj = j_pb.estimate_error_moments(name, sj, mj, jnp.asarray(scale),
                                          k, 0.05, B=150, metric=metric,
                                          interpret=True)
    et, tht = t_pb.estimate_error_moments(name, st, mt,
                                          torch.from_numpy(scale),
                                          np.asarray(k), 0.05, B=150,
                                          metric=metric)
    np.testing.assert_allclose(float(et), float(ej), rtol=_rtol(name))
    np.testing.assert_allclose(tht.numpy(), np.asarray(thj),
                               rtol=_rtol(name) / 10)


def test_bootstrap_moments_single_group_matches_interpret_kernel():
    rng = np.random.default_rng(3)
    x = rng.normal(3.0, 1.0, 700).astype(np.float32)
    mask = (np.arange(700) < 650).astype(np.float32)
    want = np.asarray(j_pb.bootstrap_moments(
        jnp.asarray(x), jnp.asarray(mask), jnp.uint32(12345), 96,
        interpret=True))
    got = t_pb.bootstrap_moments(torch.from_numpy(x), torch.from_numpy(mask),
                                 12345, 96).numpy()
    assert got.shape == want.shape == (96, 5)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_sample_store_matches_reference(jdata, tdata):
    """Permutations, gathered rows, windows, costs and rows touched equal;
    a bound derived column reads the same rows; reshuffle and refresh
    redraw the same permutations."""
    sj, st = js.SampleStore(jdata, seed=3), ts.SampleStore(tdata, seed=3)
    calls = [([300, 500], None), ([1000, 700], None), ([400, 400], [1000, 700]),
             ([1200, 1500], None), ([200, 100], None)]
    for n, base in calls:
        n = np.asarray(n)
        assert st.sample_cost(n, base) == sj.sample_cost(n, base)
        aj, mj = sj.sample(n, base)
        at, mt = st.sample(n, base)
        assert np.array_equal(at.numpy(), np.asarray(aj))
        assert np.array_equal(mt.numpy(), np.asarray(mj))
        assert st.rows_touched == sj.rows_touched
        assert st.capacity == sj.capacity
    ij, _ = sj.prefix_indices(np.asarray([800, 900]))
    it, _ = st.prefix_indices(np.asarray([800, 900]))
    assert np.array_equal(it, ij)
    hj = sj.sample_host(np.asarray([50, 60]), np.asarray([10, 20]))
    ht = st.sample_host(np.asarray([50, 60]), np.asarray([10, 20]))
    assert all(np.array_equal(a, b) for a, b in zip(ht, hj))
    ind = (np.asarray(jdata.values)[:, 0] > 4.0).astype(np.float32)
    bj, bt = sj.bind(jnp.asarray(ind)), st.bind(torch.from_numpy(ind))
    wj, _ = bj.sample(np.asarray([900, 800]))
    wt, _ = bt.sample(np.asarray([900, 800]))
    assert np.array_equal(wt.numpy(), np.asarray(wj))
    assert st.rows_touched == sj.rows_touched
    sj.reshuffle()
    st.reshuffle()
    sj.refresh(jdata)
    st.refresh(tdata)
    for store_j, store_t in ((sj, st), (bj, bt)):
        n = np.asarray([256, 300])
        assert store_t.sample_cost(n) == store_j.sample_cost(n)
        aj, _ = store_j.sample(n)
        at, _ = store_t.sample(n)
        assert np.array_equal(at.numpy(), np.asarray(aj))
    assert st.rows_touched == sj.rows_touched and st.epoch == sj.epoch == 2


def _eps(name):
    return {"sum": 5000.0, "var": 0.1, "maxq": 0.3, "min": 0.5,
            "max": 0.5}.get(name, 0.05)


@pytest.mark.parametrize("name,route", [
    ("avg", "generic"), ("avg", "entry"), ("sum", "generic"),
    ("sum", "entry"), ("var", "generic"), ("var", "entry"),
    ("std", "generic"), ("std", "entry"), ("median", "generic"),
    ("maxq", "generic"), ("min", "generic"), ("max", "generic")])
def test_run_l2miss_matches_reference(jdata, tdata, name, route):
    """Whole runs on both ESTIMATE routes: the generic bootstrap (the
    reference's jnp path) and the moments entry (the reference's kernel in
    interpret mode against the port's plain version)."""
    uk = route == "entry"
    eps = _eps(name)
    tj = j_run(jdata, name, JConfig(epsilon=eps, use_kernel=uk, **CFG))
    cfg = TConfig(epsilon=eps, use_kernel=uk, **CFG)
    tt = t_run(tdata, name, cfg)
    assert_trace_parity(tj, tt, cfg, tdata.sizes, l=CFG["l"], eps_j=eps,
                        theta_rtol=_rtol(name) / 10, err_rtol=_rtol(name))
    assert tt.info["rows_touched"] == tt.total_sampled
    assert tt.total_sampled <= int(tt.profile_n.sum())


def test_cost_weights_shape_the_allocation(jdata, tdata):
    cw = (1.0, 4.0)
    tj = j_run(jdata, "avg", JConfig(epsilon=0.05, cost_weights=cw, **CFG))
    cfg = TConfig(epsilon=0.05, cost_weights=cw, **CFG)
    tt = t_run(tdata, "avg", cfg)
    assert_trace_parity(tj, tt, cfg, tdata.sizes, l=CFG["l"], eps_j=0.05,
                        theta_rtol=1e-5, err_rtol=1e-4)
    assert tt.success and tt.n[1] < tt.n[0]     # the dearer group samples less


def test_exact_answer_matches_reference(jdata, tdata):
    for name in ("avg", "sum", "var", "median", "max"):
        want = j_exact(jdata, je.get(name))
        got = t_exact(tdata, te.get(name))
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_estimate_route_choice():
    """The host route's own switch: True takes the moments entry on any
    device (the plain version on the CPU), "auto" only on a CUDA device;
    the fused path's switch still refuses True on the CPU."""
    assert moments_entry(True, "cpu") and not moments_entry("auto", "cpu")
    assert moments_entry("auto", "cuda") and not moments_entry(False, "cuda")
    with pytest.raises(ValueError):
        moments_entry("kernel", "cpu")
    with pytest.raises(ValueError):
        resolve_use_kernel(True, "cpu")


@pytest.mark.cuda
def test_moments_entry_card_equals_cpu():
    """On the card the entry launches the CUDA kernel, bit-equal to its
    plain version on the CPU (same summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    td = t_make_grouped(["normal", "exp"], 20_000, seed=1,
                        biases=[5.0, 3.0], device="cpu")
    n_vec = np.asarray([700, 1500])
    st, mt = ts.stratified_sample(ts.root_key(2), td.values, td.offsets,
                                  n_vec, 2048)
    scale = torch.ones(2)
    before = t_pb.counter.launches
    ec, thc = t_pb.estimate_error_moments("var", st.cuda(), mt.cuda(),
                                          scale.cuda(), ts.root_key(3), 0.05,
                                          B=300)
    eh, thh = t_pb.estimate_error_moments("var", st, mt, scale,
                                          ts.root_key(3), 0.05, B=300)
    assert t_pb.counter.launches == before + 1
    assert float(ec) == float(eh) and torch.equal(thc.cpu(), thh)
