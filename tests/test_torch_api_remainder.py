"""The public-API remainder of ported files against the JAX reference: the
legacy per-lane-table ``fused_l2miss_batch`` ``(q, N, c)``,
``error_model.model_value``, ``estimators.get_by_id``,
``sampling.gap_sample_indices`` and ``kernels.kernel_backend_available``.

The legacy batch mirrors ``tests/test_core_l2miss.py::test_fused_batch_vmap``
(150 000 rows a group) and
``tests/test_core_fused_buckets.py::test_legacy_batch_shared_sample_key``
(60 000).  Its lanes are held to ``tests/test_torch_host_parity.py``'s
fused-lane contract: integer trajectories equal, or the first difference at
a PREDICT whose pre-ceil sizes straddle an integer within f32 noise, with
theta at rtol 1e-5 and errors at rtol 1e-4 where the integers agree.
Inside the port a lane equals its solo run bit for bit.  ``model_value``
at rtol 1e-6 (f32, another summation order); the gap sampler's indices
equal (the same numpy generator draws).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import error_model as jem
from repro.core import estimators as jest
from repro.core import fused as jf
from repro.core import sampling as jsampling
from repro.data import make_grouped as j_make_grouped
from repro_torch import kernels
from repro_torch.core import error_model, estimators, sampling
from repro_torch.core import fused as tf
from repro_torch.data import make_grouped as t_make_grouped
from test_torch_host_parity import _lane, assert_fused_lane_parity

VMAP_KW = dict(est_name="avg", B=100, n_min=400, n_max=800, l=6,
               max_iters=16, n_cap=1 << 13)
BUCKET_KW = dict(est_name="avg", B=100, n_min=300, n_max=600, l=6,
                 max_iters=16, n_cap=1 << 13, ext_cap=1 << 10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables(rows: int):
    args = (["normal", "exp"], rows)
    kw = dict(seed=1, biases=[5.0, 3.0])
    return j_make_grouped(*args, **kw), t_make_grouped(*args, **kw,
                                                       device="cpu")


def _assert_lanes(rj, rt, eps, kw):
    for i, e in enumerate(eps):
        assert_fused_lane_parity(
            _lane(rj, i), _lane(rt, i), eps=float(e), l=kw["l"],
            n_cap=kw["n_cap"], ext_cap=kw.get("ext_cap", 1 << 10),
            theta_rtol=1e-5, err_rtol=1e-4)


@pytest.mark.parametrize("shared", [False, True])
def test_legacy_batch_matches_reference(shared):
    """Three per-lane tables (the same data broadcast, as the reference's
    test): every lane succeeds, tighter epsilon takes more samples, each
    lane holds the contract against the reference's vmap and equals its
    solo full-width run; ``shared`` pins one sample key tiled over the
    lanes."""
    jd, td = _tables(150_000)
    q = 3
    keys = jax.random.split(jax.random.PRNGKey(1), q)
    eps = np.asarray([0.1, 0.05, 0.2], np.float32)
    skeys = (jnp.broadcast_to(jax.random.PRNGKey(7), (q, 2)) if shared
             else None)
    rj = jf.fused_l2miss_batch(
        jnp.broadcast_to(jd.values, (q,) + jd.values.shape),
        jnp.asarray(jd.offsets), jnp.ones((q, 2), jnp.float32), keys,
        jnp.asarray(eps), 0.05, skeys, **VMAP_KW)
    tkeys = np.asarray(keys)
    tskeys = None if skeys is None else np.asarray(skeys)
    rt = tf.fused_l2miss_batch(
        td.values[None].expand(q, -1, -1), td.offsets,
        np.ones((q, 2), np.float32), tkeys, eps, 0.05, tskeys, **VMAP_KW)
    assert rt.n.shape == (q, 2) and rt.profile_n.shape == (q, 16, 2)
    assert bool(rt.success.all())
    totals = rt.n.sum(dim=1)
    assert totals[1] >= totals[0] >= totals[2]
    _assert_lanes(rj, rt, eps, VMAP_KW)
    solo = tf.fused_l2miss(
        td.values, td.offsets, np.ones(2, np.float32), tkeys[1], eps[1],
        0.05, None if tskeys is None else tskeys[1], adaptive=False,
        **VMAP_KW)
    for a, b in zip(rt, solo):
        assert torch.equal(a[1], b)


def test_legacy_batch_shared_sample_key():
    """One ``(2,)`` sample key is tiled over the lanes: the same result as
    the manual broadcast, and the reference's lanes under the contract."""
    jd, td = _tables(60_000)
    q = 2
    keys = jax.random.split(jax.random.PRNGKey(4), q)
    eps = np.asarray([0.15, 0.2], np.float32)
    skey = np.asarray(jax.random.PRNGKey(7))
    vals3 = td.values[None].expand(q, -1, -1)
    r_shared = tf.fused_l2miss_batch(
        vals3, td.offsets, np.ones((q, 2), np.float32), np.asarray(keys),
        eps, 0.05, sample_keys=skey, **BUCKET_KW)
    r_tiled = tf.fused_l2miss_batch(
        vals3, td.offsets, np.ones((q, 2), np.float32), np.asarray(keys),
        eps, 0.05, sample_keys=np.broadcast_to(skey, (q, 2)), **BUCKET_KW)
    assert bool(r_shared.success.all())
    for a, b in zip(r_shared, r_tiled):
        assert torch.equal(a, b)
    rj = jf.fused_l2miss_batch(
        jnp.broadcast_to(jd.values, (q,) + jd.values.shape),
        jnp.asarray(jd.offsets), jnp.ones((q, 2), jnp.float32), keys,
        jnp.asarray(eps), 0.05, sample_keys=jnp.asarray(skey), **BUCKET_KW)
    _assert_lanes(rj, r_shared, eps, BUCKET_KW)


def test_model_value_matches_reference():
    """H(n; beta) = beta0 - sum_i beta_i log n_i, one lane and batched."""
    rng = np.random.default_rng(0)
    for m in (1, 2, 5):
        beta = rng.uniform(0.1, 2.0, (4, m + 1)).astype(np.float32)
        n = rng.integers(1, 1 << 16, (4, m)).astype(np.int32)
        want = [float(jem.model_value(jnp.asarray(b), jnp.asarray(x)))
                for b, x in zip(beta, n)]
        got = error_model.model_value(torch.from_numpy(beta),
                                      torch.from_numpy(n))
        assert got.shape == (4,) and got.dtype == torch.float32
        assert_allclose(got.numpy(), want, rtol=1e-6)
        one = error_model.model_value(torch.from_numpy(beta[0]),
                                      torch.from_numpy(n[0]))
        assert one.shape == () and float(one) == float(got[0])


def test_get_by_id_matches_reference():
    """Every registered id names the reference's estimator of that id; an
    unknown id raises ``KeyError``."""
    assert len(estimators.REGISTRY_BY_ID) >= 6
    for eid, est in enumerate(estimators.REGISTRY_BY_ID):
        got = estimators.get_by_id(eid)
        assert got is est and got.eid == eid
        assert got.name == jest.get_by_id(eid).name
        assert estimators.get_by_id(estimators.est_id(got.name)) is got
    with pytest.raises(KeyError, match="unknown estimator id"):
        estimators.get_by_id(len(estimators.REGISTRY_BY_ID))


@pytest.mark.parametrize("n_rows,p", [(1_000, 0.0), (1_000, 1.0),
                                      (1_000, 1.5), (100_000, 0.01),
                                      (60_000, 0.3), (7, 0.5)])
def test_gap_sample_indices_match_reference(n_rows, p):
    """The same generator state gives the same rows: sorted, distinct,
    within the table, about ``n_rows * p`` of them."""
    for seed in (0, 1):
        got = sampling.gap_sample_indices(np.random.default_rng(seed),
                                          n_rows, p)
        want = jsampling.gap_sample_indices(np.random.default_rng(seed),
                                            n_rows, p)
        assert got.dtype == np.int64
        assert np.array_equal(got, want)
        assert np.all(np.diff(got) > 0) and (got.size == 0 or
                                             0 <= got[0] <= got[-1] < n_rows)
    if 0 < p < 1 and n_rows >= 60_000:
        assert abs(got.size - n_rows * p) < 5 * np.sqrt(n_rows * p)


def test_kernel_backend_available_is_a_cuda_card():
    """The kernels are the default where a CUDA card is present (the
    reference: where a TPU is)."""
    assert kernels.kernel_backend_available() == torch.cuda.is_available()
    assert kernels.resolve_use_kernel("auto", "cuda") is True
    assert kernels.resolve_use_kernel("auto", "cpu") is False
