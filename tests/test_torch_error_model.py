"""The error model (WLS fit, Algorithm-2 diagnostic, Eq.-13 prediction): the
cases of test_core_error_model.py run through both packages, plus the
port's batched solve against numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import error_model as jem
from repro_torch.core import error_model as tem


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per test worker keeps
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profile(beta, sizes, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    N = np.asarray(sizes, np.float32)
    loge = beta[0] - np.log(N) @ np.asarray(beta[1:], np.float32)
    loge = (loge + noise * rng.standard_normal(len(loge))).astype(np.float32)
    return N, loge, np.ones(len(loge), np.float32)


def _both_fit(N, loge, valid):
    bj, rj = jem.fit_wls(jnp.asarray(N), jnp.asarray(loge), jnp.asarray(valid))
    bt, rt = tem.fit_wls(torch.from_numpy(N), torch.from_numpy(loge),
                         torch.from_numpy(valid))
    assert_allclose(bt.numpy(), np.asarray(bj), rtol=1e-4, atol=1e-5)
    assert_allclose(float(rt), float(rj), rtol=1e-4, atol=1e-6)
    return bt.numpy(), float(rt)


def test_fit_recovers_parameters():
    beta = np.array([1.2, 0.3, 0.2], np.float32)
    sizes = np.random.default_rng(1).choice([200, 400, 800, 1600], size=(24, 2))
    got, r2 = _both_fit(*_profile(beta, sizes, noise=0.01))
    assert_allclose(got, beta, atol=0.08)
    assert r2 > 0.97


def test_fit_ignores_invalid_rows():
    beta = np.array([0.5, 0.25, 0.25], np.float32)
    sizes = np.array([[100, 200], [200, 100], [400, 400], [800, 200],
                      [1, 1], [1, 1]])
    N, loge, _ = _profile(beta, sizes)
    loge[4:] = 99.0  # poisoned padding rows
    got, _ = _both_fit(N, loge, np.asarray([1, 1, 1, 1, 0, 0], np.float32))
    assert_allclose(got, beta, atol=1e-2)


def test_prediction_is_feasible_and_kkt_optimal():
    beta = np.asarray([0.8, 0.3, 0.15, 0.05], np.float32)
    log_eps = np.log(np.float32(0.01))
    n_hat = tem.predict_optimal_n(torch.from_numpy(beta),
                                  torch.tensor(log_eps))
    want = jem.predict_optimal_n(jnp.asarray(beta), jnp.float32(log_eps))
    assert_allclose(n_hat.numpy(), np.asarray(want), rtol=1e-5)
    # Feasibility with equality: H(n-hat) == log eps.
    h = beta[0] - np.sum(beta[1:] * np.log(n_hat.numpy()))
    assert_allclose(h, float(log_eps), rtol=1e-5)
    ratios = n_hat.numpy() / beta[1:]
    assert_allclose(ratios, ratios[0] * np.ones_like(ratios), rtol=1e-4)


@pytest.mark.parametrize("slopes,eps1,shrink", [
    ([0.05], 1e-4, 0.1), ([0.3, 0.2], 0.05, 0.5), ([1.0, 0.05, 0.5], 0.5, 0.9),
    ([0.2] * 5, 0.01, 0.3)])
def test_prediction_monotone_in_epsilon(slopes, eps1, shrink):
    beta = torch.tensor([0.4] + slopes, dtype=torch.float32)
    n1 = tem.predict_optimal_n(beta, torch.log(torch.tensor(eps1)))
    n2 = tem.predict_optimal_n(beta, torch.log(torch.tensor(eps1 * shrink)))
    assert bool(torch.all(n2 >= n1 * 0.999))
    assert_allclose(n1.numpy(), np.asarray(jem.predict_optimal_n(
        jnp.asarray(beta.numpy()), jnp.log(jnp.float32(eps1)))), rtol=1e-5)


@pytest.mark.parametrize("beta,status", [
    ([1.0, 0.3, 0.2], jem.DIAG_OK),
    ([1.0, 0.5, -0.1], jem.DIAG_RECOVERED),
    ([1.0, 1e-5, -2e-5], jem.DIAG_FAILURE),
])
def test_diagnose_matches(beta, status):
    b = np.asarray(beta, np.float32)
    out_t, st_t = tem.diagnose(torch.from_numpy(b), tau=1e-3)
    out_j, st_j = jem.diagnose(jnp.asarray(b), tau=1e-3)
    assert int(st_t) == int(st_j) == status
    assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-7)
    if status == jem.DIAG_RECOVERED:
        assert_allclose(out_t.numpy()[1:], [0.2, 0.2], atol=1e-6)


def test_fit_and_predict_pipeline():
    beta = np.array([0.9, 0.25, 0.25], np.float32)
    sizes = np.random.default_rng(3).choice([500, 1000, 2000], size=(16, 2))
    N, loge, valid = _profile(beta, sizes, noise=0.02)
    n_t, fit_t = tem.fit_and_predict(
        torch.from_numpy(N), torch.from_numpy(loge), torch.from_numpy(valid),
        torch.log(torch.tensor(0.005)), 1e-3)
    n_j, fit_j = jem.fit_and_predict(
        jnp.asarray(N), jnp.asarray(loge), jnp.asarray(valid),
        jnp.log(jnp.float32(0.005)), 1e-3)
    assert int(fit_t.status) == int(fit_j.status) == jem.DIAG_OK
    assert_allclose(n_t.numpy(), np.asarray(n_j), rtol=1e-4)
    v = beta[0] - np.sum(beta[1:] * np.log(n_t.numpy()))
    assert abs(v - np.log(0.005)) < 0.25


def test_batched_fit_equals_per_lane_fits():
    """The port fits every lane at once; each lane equals its own fit."""
    rng = np.random.default_rng(5)
    N = rng.choice([300, 600, 1200, 2400], size=(3, 8, 2)).astype(np.float32)
    loge = (0.5 - 0.3 * np.log(N).sum(-1)
            + 0.01 * rng.standard_normal((3, 8))).astype(np.float32)
    valid = (np.arange(8)[None, :] < np.asarray([[3], [6], [8]])).astype(
        np.float32)
    bb, rb = tem.fit_wls(torch.from_numpy(N), torch.from_numpy(loge),
                         torch.from_numpy(valid))
    for i in range(3):
        bi, ri = tem.fit_wls(torch.from_numpy(N[i]), torch.from_numpy(loge[i]),
                             torch.from_numpy(valid[i]))
        assert torch.equal(bb[i], bi) and torch.equal(rb[i], ri)


def test_solve_matches_numpy():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((4, 5, 5)).astype(np.float32)
    A[0, 0, 0] = 0.0      # forces a pivot swap
    b = rng.standard_normal((4, 5)).astype(np.float32)
    got = tem.solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    want = np.linalg.solve(A.astype(np.float64),
                           b.astype(np.float64)[..., None])[..., 0]
    assert_allclose(got, want, rtol=1e-3, atol=1e-4)
