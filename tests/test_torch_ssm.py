"""The port's state-space mixers (``models/ssm.py``) against the JAX
reference on the same numpy parameters and inputs: the Mamba (SSD) mixer of
reduced ``jamba-1.5-large-398b`` (d 128, d_in 256, 16 heads of 16, N 8,
chunk 16) and the RWKV6 time and channel mix of reduced ``rwkv6-7b`` (8
heads of 16, chunk 16), f32, with the parameters of a seeded tree.

Tolerance: outputs and states at rtol/atol 2e-4, the LM tests' tolerance
(f32, different summation orders); the port's chunked paths against its own
sequential oracle or decode steps at the same tolerance.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_tree_from_seed
from repro_torch.models import ssm
from repro_torch.models.config import reduced_for_smoke

TOL = dict(rtol=2e-4, atol=2e-4)


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
    from repro.models import ssm as jssm
    return dict(jax=jax, jnp=jnp, ssm=jssm)


def _layer0(arch: str, leaf: str, seed: int):
    """(cfg, numpy leaves, the port's leaves) of layer 0's ``leaf``."""
    cfg = reduced_for_smoke(get_config(arch))
    tree = lm_tree_from_seed(cfg, seed)
    node = {k: v[0] for k, v in tree["blocks"][0][leaf].items()}
    return cfg, node, lm_params_from_numpy(cfg, tree, device="cpu")[
        "layers"][0][leaf]


@pytest.fixture(scope="module")
def mamba():
    return _layer0("jamba-1.5-large-398b", "mixer", 0)


@pytest.fixture(scope="module")
def rwkv():
    return _layer0("rwkv6-7b", "tmix", 1)


def _j(jx, tree):
    return jx["jax"].tree.map(jx["jnp"].asarray, tree)


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _close_state(got, want):
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_softplus_is_the_reference_softplus(jx):
    x = np.array([-50.0, -3.0, 0.0, 1e-3, 3.0, 19.9, 20.1, 35.0, 90.0],
                 np.float32)
    want = np.asarray(jx["jax"].nn.softplus(jx["jnp"].asarray(x)))
    assert_allclose(ssm.softplus(torch.from_numpy(x)).numpy(), want,
                    rtol=1e-6, atol=0)


def test_mamba_forward_matches_reference(jx, mamba):
    """Two chunks from a zero state, then two more carrying the state and
    conv tail on: outputs and final states."""
    cfg, node, p = mamba
    jp = _j(jx, node)
    x = _x(cfg, 2, 32, 2)
    jy, jst = jx["ssm"].mamba_forward(jp, cfg, jx["jnp"].asarray(x))
    y, st = ssm.mamba_forward(p, cfg, torch.from_numpy(x))
    assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    _close_state(st, jst)
    x2 = _x(cfg, 2, 32, 3)
    jy2, jst2 = jx["ssm"].mamba_forward(jp, cfg, jx["jnp"].asarray(x2), jst)
    y2, st2 = ssm.mamba_forward(p, cfg, torch.from_numpy(x2), st)
    assert_allclose(y2.numpy(), np.asarray(jy2), **TOL)
    _close_state(st2, jst2)
    assert st2.ssm.abs().max() > 0.1


def test_mamba_decode_matches_reference_and_the_scan(jx, mamba):
    """Five decode steps after a 16-token forward equal the reference's
    steps, and the port's own forward over all 21 tokens (with the chunk
    raised to 32, one chunk of 21)."""
    cfg, node, p = mamba
    jp = _j(jx, node)
    x = _x(cfg, 2, 21, 4)
    jy, jst = jx["ssm"].mamba_forward(jp, cfg, jx["jnp"].asarray(x[:, :16]))
    y, st = ssm.mamba_forward(p, cfg, torch.from_numpy(x[:, :16]))
    outs = [y]
    for t in range(16, 21):
        xt = x[:, t:t + 1]
        jo, jst = jx["ssm"].mamba_decode(jp, cfg, jx["jnp"].asarray(xt), jst)
        o, st = ssm.mamba_decode(p, cfg, torch.from_numpy(xt), st)
        assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        _close_state(st, jst)
        outs.append(o)
    big = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           chunk=32))
    whole, st_all = ssm.mamba_forward(p, big, torch.from_numpy(x))
    assert_allclose(torch.cat(outs, 1).numpy(), whole.numpy(), **TOL)
    assert_allclose(st.ssm.numpy(), st_all.ssm.numpy(), **TOL)


@pytest.mark.parametrize("sequential", [False, True])
def test_rwkv_forward_matches_reference(jx, rwkv, sequential):
    """The chunked scan and the sequential oracle each against the
    reference's, from a zero state and then carrying it on."""
    cfg, node, p = rwkv
    jp = _j(jx, node)
    x = _x(cfg, 2, 32, 5)
    jy, jst = jx["ssm"].rwkv_forward(jp, cfg, jx["jnp"].asarray(x),
                                     sequential=sequential)
    y, st = ssm.rwkv_forward(p, cfg, torch.from_numpy(x),
                             sequential=sequential)
    assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    _close_state(st, jst)
    x2 = _x(cfg, 2, 16, 6)
    jy2, jst2 = jx["ssm"].rwkv_forward(jp, cfg, jx["jnp"].asarray(x2), jst,
                                       sequential=sequential)
    y2, st2 = ssm.rwkv_forward(p, cfg, torch.from_numpy(x2), st,
                               sequential=sequential)
    assert_allclose(y2.numpy(), np.asarray(jy2), **TOL)
    _close_state(st2, jst2)


def test_rwkv_chunked_equals_sequential_oracle(rwkv):
    """The port's chunked scan against its sequential scan over 48 tokens
    (three chunks), the log decay at both of its clamps."""
    cfg, _, p = rwkv
    x = torch.from_numpy(_x(cfg, 2, 48, 7) * 3.0)
    *_, logw, _ = ssm._rwkv_project(p, cfg, x, torch.zeros_like(x[:, :1]))
    assert float(logw.min()) == ssm.LOGW_MIN
    assert float(logw.max()) == pytest.approx(ssm.LOGW_MAX)
    y, st = ssm.rwkv_forward(p, cfg, x)
    ys, sts = ssm.rwkv_forward(p, cfg, x, sequential=True)
    assert_allclose(y.numpy(), ys.numpy(), **TOL)
    assert_allclose(st.wkv.numpy(), sts.wkv.numpy(), **TOL)


def test_rwkv_decode_and_cmix_match_reference(jx, rwkv):
    """Four decode steps after a 16-token forward, and the channel mix
    with a carried shift, against the reference."""
    cfg, node, p = rwkv
    jp = _j(jx, node)
    x = _x(cfg, 2, 20, 8)
    jy, jst = jx["ssm"].rwkv_forward(jp, cfg, jx["jnp"].asarray(x[:, :16]))
    y, st = ssm.rwkv_forward(p, cfg, torch.from_numpy(x[:, :16]))
    for t in range(16, 20):
        xt = x[:, t:t + 1]
        jo, jst = jx["ssm"].rwkv_decode(jp, cfg, jx["jnp"].asarray(xt), jst)
        o, st = ssm.rwkv_decode(p, cfg, torch.from_numpy(xt), st)
        assert_allclose(o.numpy(), np.asarray(jo), **TOL)
        _close_state(st, jst)
    _, cnode, cp = _layer0("rwkv6-7b", "cmix", 1)
    shift = _x(cfg, 2, 1, 9)
    jc, jsh = jx["ssm"].rwkv_cmix(_j(jx, cnode), cfg, jx["jnp"].asarray(x),
                                  jx["jnp"].asarray(shift))
    c, sh = ssm.rwkv_cmix(cp, cfg, torch.from_numpy(x),
                          torch.from_numpy(shift))
    assert_allclose(c.numpy(), np.asarray(jc), **TOL)
    assert np.array_equal(sh.numpy(), np.asarray(jsh))


def test_initial_states_match_reference(jx):
    for arch, init, jinit in (
            ("jamba-1.5-large-398b", ssm.init_mamba_state,
             "init_mamba_state"),
            ("rwkv6-7b", ssm.init_rwkv_state, "init_rwkv_state")):
        cfg = reduced_for_smoke(get_config(arch))
        got = init(cfg, 3, torch.float32, "cpu")
        want = getattr(jx["ssm"], jinit)(cfg, 3, jx["jnp"].float32)
        for g, w in zip(got, want):
            assert g.shape == w.shape and not g.any()


@pytest.mark.parametrize("S,ok", [(8, True), (16, True), (48, True),
                                  (24, False), (40, False)])
def test_chunk_rule_is_the_reference_rule(jx, mamba, rwkv, S, ok):
    """Both scans take a length that the chunk (16 here; RWKV's at most 32)
    divides, or one shorter than it; the port raises ``ValueError`` where
    the reference's assert fails."""
    for (cfg, node, p), fwd in ((mamba, "mamba_forward"),
                                (rwkv, "rwkv_forward")):
        x = _x(cfg, 1, S, 10)
        if ok:
            getattr(ssm, fwd)(p, cfg, torch.from_numpy(x))
            continue
        with pytest.raises(ValueError, match="not a multiple of the chunk"):
            getattr(ssm, fwd)(p, cfg, torch.from_numpy(x))
        with pytest.raises(AssertionError):
            getattr(jx["ssm"], fwd)(_j(jx, node), cfg, jx["jnp"].asarray(x))
