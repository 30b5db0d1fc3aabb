"""The port's MISS-for-LM adapters (``repro_torch.integration``) against the
reference's: ``MissEvaluator`` with a deterministic numpy loss and with a
tiny LM's per-example loss (the same ``convert``-carried weights in both
packages), ``mixture_statistics`` and ``estimate_router_load`` with a route
function re-seeded for each package.

Integer trajectories are held to ROADMAP Queue 3 item 1's contract
(``tests/test_torch_host_parity.py``): equal, with theta within rtol 1e-5
and errors within rtol 1e-4; or the first difference is a PREDICT whose two
pre-ceil sizes (each package's own f32 fit of its own profile) straddle an
integer within ``BAND`` of each other, or an acceptance test whose errors
straddle epsilon within ``ERR_BAND``.  ``model_forwards`` are equal wherever
the trajectories are.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_tree_from_seed
from repro_torch.core import error_model as tem
from repro_torch.core import keys as keylib
from repro_torch.integration import miss_router as tmr
from repro_torch.integration.miss_eval import MissEvalConfig, MissEvaluator
from repro_torch.integration.miss_mixture import mixture_statistics
from repro_torch.integration.miss_router import estimate_router_load
from repro_torch.models import model as M
from repro_torch.models.config import reduced_for_smoke
from test_torch_host_parity import (BAND, ERR_BAND, assert_trace_parity,
                                    first_divergence)

THETA_RTOL, ERR_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import error_model as jem
    from repro.integration import miss_eval as jme
    from repro.integration import miss_mixture as jmm
    from repro.integration import miss_router as jmr
    return dict(jax=jax, jnp=jnp, em=jem, eval=jme, mixture=jmm, router=jmr)


def _pre_ceil(jx, pkg, pn, pe, eps):
    """The adapters' PREDICT before its ceil: max of the Eq.-13 size of the
    package's f32 fit and the ratio step ``pn[-1] * (e / eps) ** (1 /
    sum(slopes))``."""
    loge = np.log(np.maximum(pe, 1e-30))
    k = len(loge)
    if pkg == "jax":
        jnp = jx["jnp"]
        n_hat, fit = jx["em"].fit_and_predict(
            jnp.asarray(pn, jnp.float32), jnp.asarray(loge, jnp.float32),
            jnp.ones((k,), jnp.float32), jnp.log(jnp.float32(eps)), 1e-3)
        n_hat, beta = np.asarray(n_hat, np.float64), np.asarray(fit.beta)
    else:
        f32 = dict(dtype=torch.float32)
        n_hat, fit = tem.fit_and_predict(
            torch.as_tensor(pn, **f32), torch.as_tensor(loge, **f32),
            torch.ones((k,), **f32),
            keylib.log_f32(torch.tensor(eps, **f32)), 1e-3)
        n_hat, beta = n_hat.numpy().astype(np.float64), fit.beta.numpy()
    s = max(float(beta[1:].sum()), 1e-3)
    ratio = float(pe[-1]) / eps
    if ratio > 1.0:
        n_hat = np.maximum(n_hat, pn[-1] * ratio ** (1.0 / s))
    return n_hat


def assert_miss_parity(jx, tj, tt, *, l: int, eps: float) -> str:
    """Hold the port's MissTrace ``tt`` to the reference's ``tj`` (module
    docstring); returns "equal", "predict k" or "accept k"."""
    k = first_divergence(tj, tt)
    if k is None:
        assert tj.iterations == tt.iterations
        assert tj.total_sampled == tt.total_sampled
        assert_allclose(tt.profile_e, tj.profile_e, rtol=ERR_RTOL)
        assert_allclose(np.asarray(tt.theta, np.float64),
                        np.asarray(tj.theta, np.float64), rtol=THETA_RTOL)
        return "equal"
    assert_allclose(tt.profile_e[:k], tj.profile_e[:k], rtol=ERR_RTOL)
    if k == min(len(tj.profile_e), len(tt.profile_e)):
        ej, et = tj.profile_e[k - 1], tt.profile_e[k - 1]
        assert (ej <= eps) != (et <= eps) and abs(ej - et) <= ERR_BAND * ej
        how = f"accept {k - 1}"
    else:
        assert k >= l, f"init sizes differ at {k}"
        aj = _pre_ceil(jx, "jax", tj.profile_n[:k], tj.profile_e[:k], eps)
        at = _pre_ceil(jx, "torch", tt.profile_n[:k], tt.profile_e[:k], eps)
        straddle = (np.ceil(aj) != np.ceil(at)) & (
            np.abs(aj - at) <= BAND * np.maximum(aj, 1.0))
        assert straddle.any(), (aj, at)
        how = f"predict {k}"
    assert tj.status == tt.status
    if tj.status == "ok":
        gap = np.linalg.norm(np.ravel(tt.theta) - np.ravel(tj.theta))
        assert gap <= eps and tt.error <= eps
    return how


# ---------------------------------------------------------------------------
# MissEvaluator
# ---------------------------------------------------------------------------

def _np_loss(tokens: np.ndarray) -> np.ndarray:
    """A deterministic per-example 'loss' of a token batch."""
    t = np.asarray(tokens)
    return (np.sin(t[:, :-1].astype(np.float32) * 0.37).mean(1) * 2.0
            + (t[:, 0] % 7) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def eval_domains():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 64, (3000, 17)).astype(np.int32)
            for _ in range(3)]


@pytest.mark.parametrize("eps", [0.05, 0.02, 0.01])
def test_miss_eval_numpy_loss_matches_reference(jx, eval_domains, eps):
    jnp = jx["jnp"]
    kw = dict(epsilon=eps, delta=0.1, B=100, n_min=64, n_max=128)
    tj = jx["eval"].MissEvaluator(lambda x: jnp.asarray(_np_loss(x)),
                                  eval_domains,
                                  jx["eval"].MissEvalConfig(**kw)).certify()
    seen = []

    def loss(x):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        seen.append(len(x))
        return _np_loss(x.numpy())

    ev = MissEvaluator(loss, eval_domains, MissEvalConfig(**kw),
                       device="cpu")
    tt = ev.certify()
    how = assert_miss_parity(jx, tj, tt, l=6, eps=eps)
    assert sum(seen) == tt.info["model_forwards"] and max(seen) <= 32
    assert tt.info["full_eval_forwards"] == 9000
    if how == "equal":
        assert tt.info["model_forwards"] == tj.info["model_forwards"]
    if tt.success:
        assert tt.info["model_forwards"] < tt.info["full_eval_forwards"]


def test_miss_eval_tiny_lm_matches_reference(jx):
    """The certified per-domain eval loss of reduced qwen3 (QK norm, f32)
    through both packages' ``train_logits`` on the same weights; the loss
    is ``logsumexp - gold`` averaged over positions, in f32."""
    jax, jnp = jx["jax"], jx["jnp"]
    from repro.models import model as JM

    cfg = reduced_for_smoke(get_config("qwen3-1.7b"))
    tree = lm_tree_from_seed(cfg, 11)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    rng = np.random.default_rng(12)
    domains = [rng.integers(0, cfg.vocab_size, (400, 9)).astype(np.int32)
               for _ in range(2)]

    @jax.jit
    def jloss(tokens):
        logits, _ = JM.train_logits(cfg, jparams, {"tokens": tokens[:, :-1]})
        lf = logits.astype(jnp.float32)
        gold = jnp.take_along_axis(lf, tokens[:, 1:, None], axis=-1)[..., 0]
        return jnp.mean(jax.nn.logsumexp(lf, axis=-1) - gold, axis=-1)

    def tloss(tokens):
        logits, _ = M.train_logits(cfg, params, {"tokens": tokens[:, :-1]})
        lf = logits.float()
        gold = torch.gather(lf, -1, tokens[:, 1:, None].long())[..., 0]
        return torch.mean(torch.logsumexp(lf, -1) - gold, -1)

    kw = dict(epsilon=0.05, delta=0.1, B=100, n_min=32, n_max=64)
    tj = jx["eval"].MissEvaluator(jloss, domains,
                                  jx["eval"].MissEvalConfig(**kw)).certify()
    tt = MissEvaluator(tloss, domains, MissEvalConfig(**kw),
                       device="cpu").certify()
    how = assert_miss_parity(jx, tj, tt, l=6, eps=0.05)
    assert tt.iterations > 6
    if how == "equal":
        assert tt.info["model_forwards"] == tj.info["model_forwards"]
    full = [float(tloss(torch.from_numpy(d)).mean()) for d in domains]
    if tt.success:
        assert np.linalg.norm(tt.theta.ravel() - np.asarray(full)) <= 0.1


# ---------------------------------------------------------------------------
# mixture statistics and router load
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps_rel", [0.02, 0.01])
def test_mixture_statistics_matches_reference(jx, eps_rel):
    """The engine's host route (PR 16's contract,
    ``assert_trace_parity``) on the reference test's corpus."""
    from repro.aqp import engine as jeng
    from repro.aqp import query as jq
    from repro.core import sampling as js
    from repro_torch.aqp import engine as teng
    from repro_torch.aqp import query as tq
    from repro_torch.core.sampling import GroupedData

    rng = np.random.default_rng(2)
    domains = [rng.lognormal(5.0 + 0.3 * d, 0.4, 200_000) for d in range(3)]
    want = jx["mixture"].mixture_statistics(domains, epsilon_rel=eps_rel,
                                            delta=0.1)
    got = mixture_statistics(domains, epsilon_rel=eps_rel, delta=0.1,
                             device="cpu")
    arrays = [np.asarray(d, np.float32) for d in domains]
    t_eng = teng.AQPEngine(GroupedData.from_group_arrays(arrays,
                                                         device="cpu"))
    j_eng = jeng.AQPEngine(js.GroupedData.from_group_arrays(arrays))
    qt = tq.Query(func="avg", epsilon_rel=eps_rel, delta=0.1)
    qj = jq.Query(func="avg", epsilon_rel=eps_rel, delta=0.1)
    ej, et = eps_rel * j_eng._pilot_scale(qj), eps_rel * t_eng._pilot_scale(qt)
    how = assert_trace_parity(
        want["trace"], got["trace"], t_eng._config(qt, et),
        t_eng.data.sizes, l=16, eps_j=ej, eps_t=et, theta_rtol=THETA_RTOL,
        err_rtol=ERR_RTOL)
    if how == "equal":
        assert got["docs_scanned"] == want["docs_scanned"]
        assert_allclose(got["weights"], want["weights"], rtol=THETA_RTOL)
    assert got["docs_scanned"] < got["docs_total"] == 600_000
    assert_allclose(got["weights"].sum(), 1.0, rtol=1e-6)
    truth = np.asarray([d.mean() for d in domains])
    assert_allclose(got["mean_len"], truth, rtol=0.06)


E = 8
TRUE_P = np.asarray([0.3, 0.2, 0.15, 0.1, 0.1, 0.05, 0.05, 0.05])


def _router_fns():
    """A synthetic router and token source on a fresh numpy stream (the
    reference test's), so each package sees the same one-hots."""
    rng = np.random.default_rng(3)

    def route_fn(tokens):
        return rng.choice(E, size=tokens.shape[0] * tokens.shape[1],
                          p=TRUE_P)

    def token_source(n):
        return rng.integers(0, 100, (n, 8)).astype(np.int32)

    return route_fn, token_source


def test_colmean_takes_a_mask_and_replicate_weights():
    est = tmr._colmean_estimator(3)
    x = torch.tensor([[1.0, 0, 0], [0, 1, 0], [0, 1, 0], [0, 0, 1]])
    w1 = torch.tensor([1.0, 1, 1, 0])
    assert torch.allclose(est.apply(est.prepare(x), w1),
                          torch.tensor([1 / 3, 2 / 3, 0]))
    wb = torch.stack([w1, torch.tensor([0.0, 0, 2, 2])])
    out = est.apply(est.prepare(x), wb)
    assert out.shape == (2, 3)
    assert torch.allclose(out[1], torch.tensor([0, 0.5, 0.5]))


@pytest.mark.parametrize("eps", [0.03, 0.01])
def test_router_load_matches_reference(jx, monkeypatch, eps):
    traces = {}
    for pkg, mod in (("jax", jx["router"]), ("torch", tmr)):
        real = mod.run_miss

        def capture(subs, epsilon, _real=real, _pkg=pkg, **kw):
            traces[_pkg] = _real(subs, epsilon, **kw)
            return traces[_pkg]

        monkeypatch.setattr(mod, "run_miss", capture)
    want = jx["router"].estimate_router_load(*_router_fns(), E, epsilon=eps,
                                             delta=0.1, B=100)
    got = estimate_router_load(*_router_fns(), E, epsilon=eps, delta=0.1,
                               B=100, device="cpu")
    how = assert_miss_parity(jx, traces["jax"], traces["torch"], l=4,
                             eps=eps)
    assert got.success and want.success
    assert got.iterations == traces["torch"].iterations
    if how == "equal":
        assert got.n_tokens == want.n_tokens
    assert np.linalg.norm(got.load - TRUE_P) <= 2 * eps
    assert_allclose(got.load.sum(), 1.0, rtol=1e-5)
