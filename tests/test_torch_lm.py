"""The port's dense decoder (reduced ``qwen2-1.5b``: f32, 2 layers, 4 query
heads over 1 KV head) against the JAX reference on the same weights: the
reference's parameter tree as numpy, carried over by
``lm_params_from_numpy``.  Prefill logits and caches, then decode steps with
differing per-row lengths -- one idle slot passing ``S_max``, where the
reference drops the cache write -- and the port's own prefill->decode
consistency.

Tolerance: logits and caches at rtol/atol 2e-4, the reference's own
prefill/decode consistency tolerance (f32, different summation orders);
greedy tokens are compared where the top-2 logit margin exceeds it.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.configs import ARCHS, NOT_PORTED, get_config
from repro_torch.convert import lm_params_from_numpy, lm_tree_from_seed
from repro_torch.models import attention as attn
from repro_torch.models import model as M
from repro_torch.models.config import MoEConfig, reduced_for_smoke

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
    from repro.configs import get_config as jget_config
    from repro.models import attention as jattn
    from repro.models import model as JM
    from repro.models.config import reduced_for_smoke as jreduced
    return dict(jax=jax, jnp=jnp, M=JM, attn=jattn, get_config=jget_config,
                reduced=jreduced)


@pytest.fixture(scope="module")
def cfg():
    return reduced_for_smoke(get_config("qwen2-1.5b"))


def assert_same_greedy(got, want, tol=TOL["atol"]):
    """argmax equal wherever the reference's top-2 margin exceeds tol."""
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol
    assert clear.any()
    assert np.array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def test_config_and_registry_match_reference(jx, cfg):
    """Every ported arch's config, full and reduced, equals the reference's;
    the dense variants (sliding window, QK norm, untied head) and a MoE
    variant build; the archs still in ``NOT_PORTED`` and an
    encoder-decoder config raise."""
    full = get_config("qwen2-1.5b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jx["reduced"](jx["get_config"]("qwen2-1.5b")))
    assert (full.head_dim, full.n_heads // full.n_kv_heads) == (128, 6)
    assert cfg.n_heads // cfg.n_kv_heads == 4
    assert set(ARCHS) == {"qwen2-1.5b", "qwen3-1.7b", "h2o-danube-3-4b",
                          "command-r-plus-104b", "granite-moe-1b-a400m",
                          "deepseek-moe-16b", "rwkv6-7b",
                          "jamba-1.5-large-398b"}
    for arch in ARCHS:
        want = jx["get_config"](arch)
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            want)
        assert dataclasses.asdict(reduced_for_smoke(get_config(arch))) == \
            dataclasses.asdict(jx["reduced"](want))
    assert get_config("qwen3-1.7b").qk_norm
    assert get_config("h2o-danube-3-4b").sliding_window == 4096
    assert not get_config("command-r-plus-104b").tie_embeddings
    for arch in NOT_PORTED:
        with pytest.raises(NotImplementedError, match=arch):
            get_config(arch)
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    with pytest.raises(NotImplementedError, match="not ported"):
        M.init_model(dataclasses.replace(cfg, is_encdec=True), device="cpu")
    moe = M.init_model(dataclasses.replace(
        cfg, family="moe", moe=MoEConfig(8, 2, 64)), device="cpu")
    assert moe["layers"][0]["ff"]["we_gate"].shape == (8, cfg.d_model, 64)
    for variant in (dict(sliding_window=16), dict(qk_norm=True),
                    dict(tie_embeddings=False)):
        params = M.init_model(dataclasses.replace(cfg, **variant),
                              device="cpu")
        assert ("unembed" in params) == ("tie_embeddings" in variant)


def test_reference_init_tree_carries_over(jx, cfg):
    """The reference's own initial tree (zero biases, unit gains) converts:
    same parameter count and the same teacher-forcing logits."""
    jax, jnp = jx["jax"], jx["jnp"]
    jparams = jx["M"].init_model(cfg, jax.random.PRNGKey(0))
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    assert M.count_params(params) == jx["M"].count_params(jparams)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9))
    want, _ = jx["M"].train_logits(cfg, jparams,
                                   {"tokens": jnp.asarray(tokens)})
    got, aux = M.train_logits(cfg, params, {"tokens": torch.from_numpy(tokens)})
    assert float(aux) == 0.0
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_then_decode_with_per_row_lengths_matches_reference(jx, cfg):
    jax, jnp, JM = jx["jax"], jx["jnp"], jx["M"]
    tree = lm_tree_from_seed(cfg, 0)
    jparams = jax.tree.map(jnp.asarray, tree)
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    rng = np.random.default_rng(3)
    B, S, S_max = 2, 7, 12
    prompt = rng.integers(0, cfg.vocab_size, (B, S))

    jl, jraw, _ = JM.prefill(cfg, jparams, {"tokens": jnp.asarray(prompt)})
    tl, traw, _ = M.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)})
    assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_same_greedy(tl.numpy(), np.asarray(jl))
    jk, jv = (np.asarray(a) for a in jraw[0]["mixer"])   # (nr, B, S, Hkv, dh)
    for i, (k, v) in enumerate(traw):
        assert_allclose(k.numpy(), jk[i], **TOL)
        assert_allclose(v.numpy(), jv[i], **TOL)

    # A pool of 3 slots: the two prompts (row 1 cut back to length 4, its
    # later rows stale) and an idle slot at S_max - 1 whose length passes
    # S_max on the second step.
    L, Hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    K = rng.standard_normal((L, 3, S_max, Hkv, dh)).astype(np.float32)
    V = rng.standard_normal((L, 3, S_max, Hkv, dh)).astype(np.float32)
    K[:, :B], V[:, :B] = 0.0, 0.0
    K[:, :B, :S], V[:, :B, :S] = jk, jv
    length = np.array([S, 4, S_max - 1], np.int32)
    jc = [{"mixer": jx["attn"].KVCache(
        jnp.asarray(K), jnp.asarray(V),
        jnp.asarray(np.broadcast_to(length, (L, 3))))}]
    tc = [attn.KVCache(torch.from_numpy(K[i].copy()),
                       torch.from_numpy(V[i].copy()), torch.from_numpy(length))
          for i in range(L)]
    jdecode = jax.jit(lambda p, t, c: JM.decode_step(cfg, p, t, c))
    for step in range(3):
        tok = rng.integers(0, cfg.vocab_size, (3, 1))
        jlog, jc = jdecode(jparams, jnp.asarray(tok), jc)
        tlog, tc = M.decode_step(cfg, params, torch.from_numpy(tok), tc)
        assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        assert_same_greedy(tlog.numpy(), np.asarray(jlog))
    jcache = jc[0]["mixer"]
    for i, c in enumerate(tc):
        assert np.array_equal(c.length.numpy(), np.asarray(jcache.length)[i])
        assert_allclose(c.k.numpy(), np.asarray(jcache.k)[i], **TOL)
        assert_allclose(c.v.numpy(), np.asarray(jcache.v)[i], **TOL)
    assert tc[0].length.tolist() == [S + 3, 7, S_max + 2]
    # The idle slot wrote its last row on the first step, then its writes
    # were dropped; its earlier rows are untouched.
    assert not np.array_equal(tc[0].k[2, -1].numpy(), K[0, 2, -1])
    assert np.array_equal(tc[0].k[2, :-1].numpy(), K[0, 2, :-1])


def test_prefill_decode_consistency(cfg):
    """Greedy continuation via prefill -> decode (the decode-attention op)
    matches the full forward over the extended sequence."""
    params = lm_params_from_numpy(cfg, lm_tree_from_seed(cfg, 1), device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 12)))
    last, raw, _ = M.prefill(cfg, params, {"tokens": tokens})
    caches = M.caches_from_prefill(cfg, raw, S_max=16)
    seq = tokens
    for _ in range(3):
        nxt = last[:, -1].argmax(-1)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
        last, caches = M.decode_step(cfg, params, nxt, caches)
        full, _ = M.train_logits(cfg, params, {"tokens": seq})
        assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(), **TOL)
    assert caches[0].length.tolist() == [15, 15]
