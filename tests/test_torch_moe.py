"""The port's MoE block (``models/mlp.py``: ``route``, ``capacity``,
``moe``) against the JAX reference on the same numpy parameters and inputs:
reduced ``granite-moe-1b-a400m`` (8 experts, top-2) and
``deepseek-moe-16b`` (8 experts, top-2, 2 shared experts), f32.

Tolerance: outputs at rtol/atol 2e-4, the LM tests' tolerance (f32,
different summation orders), compared token by token where the router's
k-th and (k+1)-th probabilities lie more than 1e-6 apart (XLA's and torch's
f32 softmax differ in the last ulps, so a closer pair may pick other
experts); the fixtures hold few such tokens.  The aux loss at rtol 1e-5.
Capacity drops couple a call's tokens, so the dropping case asserts that
the fixture has no near tie at all and that the reference did drop
entries.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_tree_from_seed
from repro_torch.models import mlp
from repro_torch.models import model as M
from repro_torch.models.config import reduced_for_smoke

TOL = dict(rtol=2e-4, atol=2e-4)
TIE = 1e-6


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
    from repro.models import mlp as jmlp
    from repro.models import model as JM
    from repro.models import nn as jnn
    return dict(jax=jax, jnp=jnp, mlp=jmlp, M=JM, nn=jnn)


def small(arch: str, **moe):
    cfg = reduced_for_smoke(get_config(arch))
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


def ff_params(cfg, seed):
    """Layer 0's MoE leaves of a seeded tree, as numpy and as the port's."""
    tree = lm_tree_from_seed(cfg, seed)
    ff = {k: (v[0] if not isinstance(v, dict) else
              {kk: vv[0] for kk, vv in v.items()})
          for k, v in tree["blocks"][0]["ff"].items()}
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    return ff, params["layers"][0]["ff"]


def run_both(jx, cfg, ff_np, ff_t, x):
    jnp = jx["jnp"]
    jff = jx["jax"].tree.map(jnp.asarray, ff_np)
    jy, jaux = jx["mlp"].moe(jff, cfg, jnp.asarray(x))
    y, aux = mlp.moe(ff_t, cfg, torch.from_numpy(x))
    xt = jnp.asarray(x.reshape(-1, cfg.d_model))
    probs = jx["jax"].nn.softmax(jx["nn"].dense(jff["router"], xt), axis=-1)
    jgate, jchoice = jx["jax"].lax.top_k(probs, cfg.moe.top_k)
    jgate = jgate / jnp.maximum(jgate.sum(-1, keepdims=True), 1e-9)
    return (y.numpy(), float(aux), np.asarray(jy), float(jaux),
            np.asarray(probs), np.asarray(jgate), np.asarray(jchoice))


def clear_tokens(probs, k):
    """Tokens whose k-th and (k+1)-th probabilities are more than TIE
    apart."""
    top = np.sort(probs, axis=-1)[:, ::-1]
    return top[:, k - 1] - top[:, k] > TIE


def dropped(choice, T, cfg) -> int:
    """Entries past capacity in the reference's routing."""
    C = mlp.capacity(T, cfg.moe)
    counts = np.bincount(choice.reshape(-1), minlength=cfg.moe.num_experts)
    return int(np.maximum(counts - C, 0).sum())


def test_capacity_is_the_reference_capacity(jx):
    for arch in ("granite-moe-1b-a400m", "deepseek-moe-16b"):
        for cf in (1.0, 1.25, 8.0):
            mo = dataclasses.replace(get_config(arch).moe, capacity_factor=cf)
            for T in (1, 8, 9, 100, 1024):
                assert mlp.capacity(T, mo) == jx["mlp"]._capacity(T, mo)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-moe-16b"])
def test_route_matches_reference(jx, arch):
    """The router's probabilities, gates and choices equal the reference's
    softmax and ``lax.top_k`` wherever no near tie decides."""
    cfg = small(arch)
    ff_np, ff_t = ff_params(cfg, 0)
    x = np.random.default_rng(1).standard_normal((64, cfg.d_model)).astype(
        np.float32)
    *_, probs, jgate, jchoice = run_both(jx, cfg, ff_np, ff_t, x[None])
    tp, tg, tc = mlp.route(ff_t, cfg, torch.from_numpy(x))
    assert_allclose(tp.numpy(), probs, rtol=1e-5, atol=1e-7)
    ok = clear_tokens(probs, cfg.moe.top_k)
    assert ok.sum() >= 62
    assert np.array_equal(np.sort(tc.numpy()[ok], -1),
                          np.sort(jchoice[ok], -1))
    assert_allclose(tg.numpy()[ok], jgate[ok], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-moe-16b"])
def test_moe_without_drops_matches_reference(jx, arch):
    """capacity_factor 8.0 (C >= T k, as the reference's own dense-expert
    test): every entry kept; outputs token by token and the aux loss."""
    cfg = small(arch, capacity_factor=8.0)
    ff_np, ff_t = ff_params(cfg, 2)
    x = np.random.default_rng(3).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    y, aux, jy, jaux, probs, _, jchoice = run_both(jx, cfg, ff_np, ff_t, x)
    assert dropped(jchoice, 48, cfg) == 0
    ok = clear_tokens(probs, cfg.moe.top_k)
    assert ok.sum() >= 46
    assert_allclose(y.reshape(48, -1)[ok], jy.reshape(48, -1)[ok], **TOL)
    assert_allclose(aux, jaux, rtol=1e-5)


def test_moe_with_drops_matches_reference(jx):
    """The default capacity factor 1.25 over 96 tokens: the reference drops
    entries (full experts drop the later tokens in sorted order), and the
    port drops the same ones -- outputs equal for every token, the dropped
    ones included.  The fixture has no near tie."""
    cfg = small("granite-moe-1b-a400m")
    ff_np, ff_t = ff_params(cfg, 4)
    x = np.random.default_rng(5).standard_normal(
        (3, 32, cfg.d_model)).astype(np.float32)
    y, aux, jy, jaux, probs, _, jchoice = run_both(jx, cfg, ff_np, ff_t, x)
    assert clear_tokens(probs, cfg.moe.top_k).all()
    assert dropped(jchoice, 96, cfg) > 0
    assert_allclose(y, jy, **TOL)
    assert_allclose(aux, jaux, rtol=1e-5)
    # The same tokens with room for all: the outputs differ where drops were.
    roomy = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    y_all, _ = mlp.moe(ff_t, roomy, torch.from_numpy(x))
    assert not np.allclose(y_all.numpy(), y, **TOL)


def test_shared_experts_add_the_dense_mlp(jx):
    """DeepSeek's shared experts are one dense SwiGLU of width 2 d_expert
    added to every token: removing them from both packages' params leaves
    the difference equal to ``mlp`` of the input."""
    cfg = small("deepseek-moe-16b", capacity_factor=8.0)
    assert cfg.moe.num_shared == 2
    ff_np, ff_t = ff_params(cfg, 6)
    assert ff_t["shared"]["wi_gate"].shape == (cfg.d_model,
                                               2 * cfg.moe.d_expert)
    x = np.random.default_rng(7).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32)
    y, _ = mlp.moe(ff_t, cfg, torch.from_numpy(x))
    bare = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            num_shared=0))
    y0, _ = mlp.moe({k: v for k, v in ff_t.items() if k != "shared"}, bare,
                    torch.from_numpy(x))
    shared = mlp.mlp(ff_t["shared"], torch.from_numpy(x))
    assert_allclose((y - y0).numpy(), shared.numpy(), rtol=1e-5, atol=1e-5)
    jy, _ = jx["mlp"].moe(jx["jax"].tree.map(jx["jnp"].asarray, ff_np), cfg,
                          jx["jnp"].asarray(x))
    assert_allclose(y.numpy(), np.asarray(jy), **TOL)


def test_two_calls_are_bit_equal():
    """The combine adds each token's contributions in one fixed order, so
    repeat calls give the same bits (with drops and shared experts)."""
    cfg = small("deepseek-moe-16b")
    _, ff_t = ff_params(cfg, 8)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, 32, cfg.d_model)).astype(np.float32))
    a, aux_a = mlp.moe(ff_t, cfg, x)
    b, aux_b = mlp.moe(ff_t, cfg, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_decode_sized_calls_never_drop():
    """At most 8 tokens a call: capacity 8 or more, and an expert receives
    at most one entry a token, so nothing drops."""
    for arch in ("granite-moe-1b-a400m", "deepseek-moe-16b",
                 "jamba-1.5-large-398b"):
        mo = get_config(arch).moe
        for T in range(1, 9):
            assert mlp.capacity(T, mo) >= T


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-moe-16b",
                                  "jamba-1.5-large-398b"])
def test_count_active_params_matches_reference(jx, arch):
    """Active parameters per token (top_k of num_experts routed experts)
    on the same tree equal the reference's count, as do all parameters."""
    cfg = reduced_for_smoke(get_config(arch))
    tree = lm_tree_from_seed(cfg, 0)
    jparams = jx["jax"].tree.map(jx["jnp"].asarray, tree)
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    assert M.count_params(params) == jx["M"].count_params(jparams)
    got = M.count_active_params(cfg, params)
    assert got == jx["M"].count_active_params(cfg, jparams)
    assert got < M.count_params(params)
