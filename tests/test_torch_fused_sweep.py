"""Sweep of the fused L2Miss loop in both packages beyond the test fixtures:
avg/sum/var/std x l2/linf/l1 x bootstrap keys {3, 7} on two tables --
["normal", "exp"] with biases [5, 3] (60 000 rows a group) and ["normal",
"exp", "uniform"] with biases [2, 1, 4] (30 000 rows a group), both from
``make_grouped(..., seed=2)`` -- at test_torch_fused.py's ``KW``, epsilon
0.1 (100 for sum).

The integer trajectories agree except where a PREDICT's ``ceil`` lands
within f32 noise of an integer: the two packages' f32 WLS solves differ by
up to ~1e-4 relative on identical inputs.  Each case asserts, through
tests/test_torch_host_parity.py's fused-lane contract, that its integers are
equal or that the first difference starts at a PREDICT whose two pre-ceil
sizes straddle an integer within ``BAND`` (2e-3 relative) -- or at an
acceptance test whose errors straddle epsilon within ``ERR_BAND``.  Where
the integers agree theta holds rtol 1e-5, and 1e-4 for var/std (their
finish cancels, E[x^2] - mu^2; up to 5.6e-5 measured); errors rtol 1e-4,
and 2e-3 for var/std (1.3e-4 measured).

Every lane of one table and metric runs in one heterogeneous-lane call of
``fused_l2miss_lanes`` (a lane equals its solo ``fused_l2miss`` run, held
once below), so JAX compiles once per table and metric.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimators as je
from repro.core import fused as jf
from repro.data import make_grouped as j_make_grouped
from repro_torch import convert
from repro_torch.core import fused as tf
from repro_torch.data import make_grouped as t_make_grouped
from test_torch_host_parity import _lane, assert_fused_lane_parity

KW = dict(B=100, n_min=300, n_max=600, l=6, max_iters=16, n_cap=1 << 13,
          ext_cap=1 << 10)
TABLES = {
    "two": (["normal", "exp"], 60_000, [5.0, 3.0]),
    "three": (["normal", "exp", "uniform"], 30_000, [2.0, 1.0, 4.0]),
}
ESTS = ("avg", "sum", "var", "std")
KEYS = (3, 7)
LANES = [(e, k) for e in ESTS for k in KEYS]


def _eps(est):
    return 100.0 if est == "sum" else 0.1


@functools.lru_cache(maxsize=None)
def _tables(name):
    dists, n, biases = TABLES[name]
    return (j_make_grouped(dists, n, seed=2, biases=biases),
            t_make_grouped(dists, n, seed=2, biases=biases, device="cpu"))


def _lane_args(data):
    m = data.num_groups
    scale = np.stack([np.asarray(
        data.scale if je.get(e).needs_population_scale else np.ones(m),
        np.float32) for e, _ in LANES])
    keys = np.stack([np.asarray(jax.random.PRNGKey(k)) for _, k in LANES])
    eps = np.asarray([_eps(e) for e, _ in LANES], np.float32)
    fids = np.asarray([je.moment_family_index(e) for e, _ in LANES],
                      np.int32)
    return scale, keys, eps, fids


@functools.lru_cache(maxsize=None)
def _sweep(table, metric):
    """Both packages' results of every lane of one table and metric."""
    jd, td = _tables(table)
    scale, keys, eps, fids = _lane_args(jd)
    q = len(LANES)
    rj = jf.fused_l2miss_lanes(
        jd.values, jnp.asarray(jd.offsets), jnp.asarray(scale),
        jnp.asarray(keys), jnp.asarray(eps), jnp.full((q,), 0.05),
        est_fids=jnp.asarray(fids), est_name=None, metric=metric, **KW)
    with _two_threads():
        rt = tf.fused_l2miss_lanes(
            td.values, td.offsets, scale, keys, eps,
            np.full((q,), 0.05, np.float32), est_fids=fids, est_name=None,
            metric=metric, **KW)
    return rj, rt


class _two_threads:
    """Two intra-op threads: the plain bootstrap's weight hashing is the
    sweep's cost, and the other test workers run one thread each."""

    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(2)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("est", ESTS)
@pytest.mark.parametrize("metric", ["l2", "linf", "l1"])
@pytest.mark.parametrize("table", list(TABLES))
def test_fused_sweep_integers_agree_or_straddle(table, metric, est, key):
    rj, rt = _sweep(table, metric)
    i = LANES.index((est, key))
    cancels = est in ("var", "std")
    assert_fused_lane_parity(
        _lane(rj, i), _lane(rt, i), eps=_eps(est), l=KW["l"],
        n_cap=KW["n_cap"], ext_cap=KW["ext_cap"],
        theta_rtol=1e-4 if cancels else 1e-5,
        err_rtol=2e-3 if cancels else 1e-4, metric=metric)


def test_sweep_lane_equals_solo_fused_l2miss():
    """A heterogeneous lane of the sweep is its solo ``fused_l2miss`` run,
    bit for bit, in both packages."""
    rj, rt = _sweep("two", "l2")
    jd, td = _tables("two")
    i = LANES.index(("var", 3))
    sj = jf.fused_l2miss(jd.values, jnp.asarray(jd.offsets),
                         jnp.ones(2, jnp.float32), jax.random.PRNGKey(3),
                         jnp.float32(0.1), 0.05, est_name="var", **KW)
    with _two_threads():
        st = tf.fused_l2miss(td.values, td.offsets, np.ones(2, np.float32),
                             convert.key_from_numpy(np.asarray(
                                 jax.random.PRNGKey(3))), 0.1, 0.05,
                             est_name="var", **KW)
    for f in ("n", "error", "theta", "iterations", "profile_n"):
        assert np.array_equal(np.asarray(getattr(sj, f)),
                              np.asarray(getattr(rj, f))[i]), f
        assert np.array_equal(getattr(st, f).numpy(),
                              getattr(rt, f).numpy()[i]), f
