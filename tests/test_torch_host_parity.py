"""Parity contract of the port's host route (MissTrace) against the
reference, shared by the ``test_torch_host_*`` files (and tests of the
contract's own checks at the end).

The two packages sum f32 in different orders (XLA against torch, a Pallas
interpret-mode kernel against its plain port), and their f32 WLS solves of
the error model differ by up to ~1e-4 relative on identical inputs (a
fraction of a row at these sizes), since the normal equations' condition
number reaches ~1e4.  A PREDICT ends in a ``ceil``, so where a pre-ceil
allocation lies within that noise of an integer the two runs take sizes a
row apart, and from there they sample different rows.  The contract for a
host run (a fused lane's is at the end of the file):

* the integer trajectory (profile sizes, iterations, status,
  total_sampled) is equal, and then theta and error agree within the
  caller's rtols; or
* the first difference is explained: either at a PREDICT whose two pre-ceil
  allocations (each package's own f32 fit of its own profile, then the
  shared float64 host step) straddle an integer and lie within ``BAND`` of
  each other, or at an acceptance test whose two errors straddle epsilon
  and agree within ``ERR_BAND``.  Beyond it the runs must end in the same
  status with answers within the run's own L2 bound of each other.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import error_model as jem
from repro_torch.core import error_model as tem
from repro_torch.core.l2miss import LOG_FLOOR, allocate

BAND = 2e-3         # relative distance of two straddling pre-ceil allocations
ERR_BAND = 2e-3     # relative distance of two errors straddling epsilon


def first_divergence(tj, tt) -> Optional[int]:
    """First iteration whose sample sizes differ (or the shorter length
    when one run stops first); None when the trajectories are equal."""
    k = min(len(tj.profile_e), len(tt.profile_e))
    for i in range(k):
        if not np.array_equal(tj.profile_n[i], tt.profile_n[i]):
            return i
    if len(tj.profile_e) != len(tt.profile_e) or tj.status != tt.status:
        return k
    return None


def _fit(pkg: str, profile_n, profile_e, eps, cost_weights):
    loge = np.log(np.maximum(profile_e, np.exp(LOG_FLOOR)))
    k = len(loge)
    if pkg == "jax":
        cw = (None if cost_weights is None
              else jnp.asarray(cost_weights, jnp.float32))
        n_hat, fit = jem.fit_and_predict(
            jnp.asarray(profile_n, jnp.float32),
            jnp.asarray(loge, jnp.float32), jnp.ones((k,), jnp.float32),
            jnp.log(jnp.float32(eps)), 1e-3, cost_weights=cw)
        return np.asarray(n_hat), np.asarray(fit.beta)
    f32 = dict(dtype=torch.float32)
    cw = (None if cost_weights is None
          else torch.as_tensor(cost_weights, **f32))
    n_hat, fit = tem.fit_and_predict(
        torch.as_tensor(profile_n, **f32), torch.as_tensor(loge, **f32),
        torch.ones((k,), **f32), torch.log(torch.tensor(eps, **f32)), 1e-3,
        cost_weights=cw)
    return n_hat.numpy(), fit.beta.numpy()


def _pre_ceil(pkg, tr, k, l, eps, cfg, sizes):
    """(pre-ceil allocation, resulting sizes) of PREDICT k of ``tr``."""
    pn, pe = tr.profile_n[:k], tr.profile_e[:k]
    prev = pn.max(axis=0) if k == l else pn[k - 1]
    n_hat, beta = _fit(pkg, pn, pe, eps, cfg.cost_weights)
    alloc = allocate(n_hat, beta, pn, pe, prev,
                     dataclasses.replace(cfg, epsilon=eps))
    n_next = np.minimum(np.maximum(np.ceil(alloc).astype(np.int64),
                                   prev + 1), sizes)
    return alloc, n_next


def assert_trace_parity(tj, tt, cfg, sizes, *, l: int, eps_j: float,
                        eps_t: Optional[float] = None, theta_rtol: float,
                        err_rtol: float, theta_atol: float = 0.0) -> str:
    """Hold a port MissTrace ``tt`` to the reference's ``tj`` (module
    docstring).  ``cfg`` is the port's MissConfig, ``eps_j``/``eps_t`` the
    L2 epsilon each run used (after any Gamma conversion).  Returns
    "equal", "predict k" or "accept k" (how the runs relate)."""
    eps_t = eps_j if eps_t is None else eps_t
    k = first_divergence(tj, tt)
    if k is None:
        assert tj.iterations == tt.iterations
        assert tj.total_sampled == tt.total_sampled
        assert np.array_equal(np.asarray(tj.n), np.asarray(tt.n))
        np.testing.assert_allclose(tt.profile_e, tj.profile_e,
                                   rtol=err_rtol)
        np.testing.assert_allclose(np.asarray(tt.theta, np.float64),
                                   np.asarray(tj.theta, np.float64),
                                   rtol=theta_rtol, atol=theta_atol)
        assert abs(tt.error - tj.error) <= err_rtol * abs(tj.error)
        return "equal"
    np.testing.assert_allclose(tt.profile_e[:k], tj.profile_e[:k],
                               rtol=err_rtol)
    n_common = min(len(tj.profile_e), len(tt.profile_e))
    if k == n_common:
        # One run accepted at iteration k - 1, the other did not.
        ej, et = tj.profile_e[k - 1], tt.profile_e[k - 1]
        assert (ej <= eps_j) != (et <= eps_t), (ej, et, eps_j, eps_t)
        assert abs(ej - et) <= ERR_BAND * ej, (ej, et)
        how = f"accept {k - 1}"
    else:
        assert k >= l, f"init sizes differ at {k}"
        aj, nj = _pre_ceil("jax", tj, k, l, eps_j, cfg, sizes)
        at, nt = _pre_ceil("torch", tt, k, l, eps_t, cfg, sizes)
        # The float64 host step reproduces each package's own sizes.
        assert np.array_equal(nj, tj.profile_n[k]), (nj, tj.profile_n[k])
        assert np.array_equal(nt, tt.profile_n[k]), (nt, tt.profile_n[k])
        straddle = (np.ceil(aj) != np.ceil(at)) & (
            np.abs(aj - at) <= BAND * np.maximum(aj, 1.0))
        assert straddle.any(), (aj, at)
        how = f"predict {k}"
    assert tj.status == tt.status, (tj.status, tt.status)
    if tj.status == "ok":
        assert tt.error <= eps_t and tj.error <= eps_j
        gap = np.linalg.norm(np.ravel(tt.theta) - np.ravel(tj.theta))
        assert gap <= max(eps_j, eps_t), (gap, eps_j)
    return how


# ---------------------------------------------------------------------------
# fused lanes (core/fused.py): the same contract on a FusedResult lane
# ---------------------------------------------------------------------------

def _lane(r, i=None) -> dict:
    """Host copies of one lane of a FusedResult (either package); ``i``
    selects lane i of a batched or grouped result (a grouped lane has
    m = 1, so its profile gains a group axis)."""
    out = {}
    for f in r._fields:
        v = getattr(r, f)
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[f] = v if i is None else v[i]
    if out["profile_n"].ndim == 1:
        out["profile_n"] = out["profile_n"][:, None]
    return out


def _fused_pre_ceil(pkg: str, lane: dict, k: int, eps: float,
                    tau: float = 1e-3):
    """The two pre-ceil sizes of a fused lane's PREDICT at tick k --
    ``n_hat`` of the f32 fit over the padded profile and the local-model
    step ``n_cur * ratio ** (1 / slope)`` -- rebuilt from the lane's
    recorded profile with the package's own error model."""
    pn = np.array(lane["profile_n"], np.float32)
    max_iters = pn.shape[0]
    pn[k:] = 1.0
    loge = np.zeros(max_iters, np.float32)
    loge[:k] = np.maximum(np.log(np.maximum(
        lane["profile_e"][:k].astype(np.float32), 1e-30)), LOG_FLOOR)
    rv = (np.arange(max_iters) < k).astype(np.float32)
    if pkg == "jax":
        n_hat, fit = jem.fit_and_predict(
            jnp.asarray(pn), jnp.asarray(loge), jnp.asarray(rv),
            jnp.log(jnp.float32(eps)), tau)
        n_hat, beta = np.asarray(n_hat), np.asarray(fit.beta)
    else:
        n_hat, fit = tem.fit_and_predict(
            torch.from_numpy(pn), torch.from_numpy(loge),
            torch.from_numpy(rv), torch.log(torch.tensor(eps)), tau)
        n_hat, beta = n_hat.numpy(), fit.beta.numpy()
    slope = np.float32(max(np.float32(beta[1:].sum()), np.float32(1e-3)))
    ratio = np.float32(max(np.float32(lane["profile_e"][k - 1])
                           / np.float32(eps), np.float32(1.0)))
    local = pn[k - 1] * ratio ** (np.float32(1.0) / slope)
    return n_hat, local


def _filled(profile_n: np.ndarray, k: int, l: int, n_cap: int) -> np.ndarray:
    """The lane's gathered watermark before tick k: init probes read stacked
    windows, prediction ticks the prefix."""
    filled = np.zeros(profile_n.shape[1])
    for i in range(k):
        n = profile_n[i]
        hi = np.minimum(filled, n_cap - n) + n if i < l else n
        filled = np.maximum(filled, hi)
    return filled


def assert_fused_lane_parity(lj: dict, lt: dict, *, eps: float, l: int,
                             n_cap: int, ext_cap: int, theta_rtol: float,
                             err_rtol: float, metric: str = "l2") -> str:
    """Hold a port fused lane ``lt`` to the reference's ``lj`` (``_lane``
    dicts): integers equal with theta/error within rtol, or the first
    difference at a PREDICT whose sizes lie within ``BAND`` of each other
    (as do each package's rebuilt pre-ceil sizes of its own), or at an
    acceptance test whose errors straddle epsilon within ``ERR_BAND``; beyond it the same verdict, each error within epsilon,
    answers within epsilon of each other in the lane's metric."""
    ij, it = int(lj["iterations"]), int(lt["iterations"])
    n_common = min(ij, it)
    k = next((i for i in range(n_common)
              if not np.array_equal(lj["profile_n"][i], lt["profile_n"][i])),
             None)
    if k is None and (ij != it or bool(lj["success"]) != bool(lt["success"])):
        k = n_common
    if k is None:
        for f in ("n", "iterations", "success", "failed", "rows_sampled"):
            assert np.array_equal(lt[f], lj[f]), f
        np.testing.assert_allclose(lt["theta"], lj["theta"], rtol=theta_rtol)
        np.testing.assert_allclose(lt["error"], lj["error"], rtol=err_rtol)
        return "equal"
    np.testing.assert_allclose(lt["profile_e"][:k], lj["profile_e"][:k],
                               rtol=err_rtol)
    if k == n_common:
        ej, et = lj["profile_e"][k - 1], lt["profile_e"][k - 1]
        assert (ej <= eps) != (et <= eps), (ej, et, eps)
        assert abs(ej - et) <= ERR_BAND * ej, (ej, et)
        how = f"accept {k - 1}"
    else:
        assert k >= l, f"init sizes differ at tick {k}"
        nj, nt = lj["profile_n"][k], lt["profile_n"][k]
        # The sizes lie within BAND (plus the ceil's one row) of each
        # other, and each package's rebuilt pre-ceil size (the larger of the
        # two ceil candidates) within BAND of its own size.  The rebuild runs
        # the fit outside the fused program, whose f32 rounding it
        # reproduces only to the same ~1e-4 noise.
        assert np.all(np.abs(nj - nt) <= BAND * nj + 1), (nj, nt)
        for pkg, lane, n in (("jax", lj, nj), ("torch", lt, nt)):
            # A tick extends a group by at most ext_cap rows.
            x = np.minimum(np.maximum(*_fused_pre_ceil(pkg, lane, k, eps)),
                           _filled(lane["profile_n"], k, l, n_cap) + ext_cap)
            live = x > lane["profile_n"][k - 1]   # not held by the guard
            assert np.all(np.abs(x - n)[live] <= BAND * n[live] + 1), (
                pkg, x, n)
        how = f"predict {k}"
    assert bool(lj["success"]) == bool(lt["success"])
    if bool(lj["success"]):
        assert lt["error"] <= eps and lj["error"] <= eps
        d = np.ravel(lt["theta"]) - np.ravel(lj["theta"])
        gap = {"l2": np.linalg.norm(d), "linf": np.abs(d).max(),
               "l1": np.abs(d).sum()}[metric]
        assert gap <= eps, (gap, eps)
    return how


# ---------------------------------------------------------------------------
# the contract's own checks
# ---------------------------------------------------------------------------

def _trace(profile_n, profile_e, status="ok", theta=(1.0, 2.0)):
    from repro_torch.core.framework import MissTrace

    pn = np.asarray(profile_n, np.int64)
    return MissTrace(success=status == "ok", status=status, n=pn[-1],
                     theta=np.asarray(theta)[:, None],
                     error=float(profile_e[-1]), iterations=len(profile_e),
                     profile_n=pn, profile_e=np.asarray(profile_e),
                     total_sampled=int(pn.sum()), wall_time_s=0.0, info={})


def test_first_divergence_finds_sizes_lengths_and_verdicts():
    a = _trace([[10, 10], [20, 20]], [0.3, 0.1])
    assert first_divergence(a, _trace([[10, 10], [20, 20]], [0.3, 0.1])) \
        is None
    assert first_divergence(a, _trace([[10, 10], [21, 20]], [0.3, 0.1])) == 1
    assert first_divergence(a, _trace([[10, 10], [20, 20], [40, 40]],
                                      [0.3, 0.11, 0.1])) == 2
    assert first_divergence(a, _trace([[10, 10], [20, 20]], [0.3, 0.1],
                                      status="max_iters")) == 2


def test_acceptance_straddle_is_explained_and_others_are_not():
    """Runs that part at an acceptance test whose errors straddle epsilon
    within ERR_BAND pass; a difference in the init probes fails."""
    from repro_torch.core.l2miss import MissConfig

    cfg = MissConfig(epsilon=0.1)
    j = _trace([[10, 10], [20, 20]], [0.3, 0.0999])
    t = _trace([[10, 10], [20, 20], [40, 40]], [0.3, 0.10001, 0.05],
               theta=(1.0, 2.01))
    assert assert_trace_parity(j, t, cfg, np.asarray([100, 100]), l=1,
                               eps_j=0.1, theta_rtol=1e-5,
                               err_rtol=2e-3) == "accept 1"
    bad = _trace([[11, 10], [20, 20]], [0.3, 0.0999])
    with pytest.raises(AssertionError):
        assert_trace_parity(j, bad, cfg, np.asarray([100, 100]), l=2,
                            eps_j=0.1, theta_rtol=1e-5, err_rtol=1e-4)
