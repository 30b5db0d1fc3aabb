"""The port's dense decoder variants against the JAX reference on the same
weights (``lm_tree_from_seed`` carried over by ``lm_params_from_numpy``):
reduced ``qwen3-1.7b`` (per-head QK norm, tied head), ``h2o-danube-3-4b``
(sliding window, cut to 16 positions so prompts pass it; untied head) and
``command-r-plus-104b`` (untied head), f32.  Teacher-forcing logits, prefill
logits and caches, decode steps with rows at ``length`` window - 1, window
and window + 1, and the batcher's greedy tokens with prompts longer than
the window.

Tolerance: logits and caches at rtol/atol 2e-4, as ``tests/test_torch_lm.py``
(f32, different summation orders); greedy tokens compared where the top-2
logit margin exceeds it, and the batcher's tokens exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_tree_from_seed
from repro_torch.models import attention as attn
from repro_torch.models import flops
from repro_torch.models import model as M
from repro_torch.models.config import reduced_for_smoke
from repro_torch.serve.batching import ContinuousBatcher, Request

TOL = dict(rtol=2e-4, atol=2e-4)
WINDOW = 16
ARCHS = ["qwen3-1.7b", "h2o-danube-3-4b", "command-r-plus-104b"]


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
    from repro.models import attention as jattn
    from repro.models import model as JM
    from repro.serve import batching as jb
    return dict(jax=jax, jnp=jnp, M=JM, attn=jattn, batching=jb)


def small(arch: str):
    cfg = reduced_for_smoke(get_config(arch))
    if cfg.sliding_window is not None:
        cfg = dataclasses.replace(cfg, sliding_window=WINDOW)
    return cfg


def assert_same_greedy(got, want, tol=TOL["atol"]):
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol
    assert clear.any()
    assert np.array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def _both(jx, cfg, seed):
    tree = lm_tree_from_seed(cfg, seed)
    return (jx["jax"].tree.map(jx["jnp"].asarray, tree),
            lm_params_from_numpy(cfg, tree, device="cpu"))


def test_variant_features_and_leaves(jx):
    """Each reduced config keeps its family's feature, and the carried
    parameters hold exactly the reference tree's leaves."""
    q3, h2o, cr = (small(a) for a in ARCHS)
    assert q3.qk_norm and q3.tie_embeddings and q3.sliding_window is None
    assert h2o.sliding_window == WINDOW and not h2o.tie_embeddings
    assert not cr.tie_embeddings and not cr.qk_norm
    assert get_config("h2o-danube-3-4b").head_dim == 120
    for cfg in (q3, h2o, cr):
        jparams, params = _both(jx, cfg, 0)
        assert M.count_params(params) == jx["M"].count_params(jparams)
        assert ("unembed" in params) != cfg.tie_embeddings
        assert ("tied_head" in params) == cfg.tie_embeddings
        assert ("q_norm" in params["layers"][0]["mixer"]) == cfg.qk_norm
        assert params["layers"][0]["mixer"].get(
            "q_norm", torch.zeros(1)).dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_reference(jx, arch):
    cfg = small(arch)
    jparams, params = _both(jx, cfg, 1)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40))
    want, _ = jx["M"].train_logits(cfg, jparams,
                                   {"tokens": jx["jnp"].asarray(tokens)})
    got, _ = M.train_logits(cfg, params, {"tokens": torch.from_numpy(tokens)})
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_same_greedy(got.numpy(), np.asarray(want))


def test_window_mask_is_the_reference_mask(jx):
    for S, T, w in ((7, 7, None), (40, 40, WINDOW), (5, 12, 3)):
        want = np.asarray(jx["attn"].causal_mask(S, T, w))
        assert np.array_equal(attn.causal_mask(S, T, w).numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_across_the_window(jx, arch):
    """Prefill a 20-token prompt (past the window), then decode 3 steps on
    a pool of rows at lengths window - 1, window and window + 1 (stale
    rows beyond each length), against the reference's decode step."""
    jax, jnp, JM = jx["jax"], jx["jnp"], jx["M"]
    cfg = small(arch)
    jparams, params = _both(jx, cfg, 3)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (1, 20))
    jl, jraw, _ = JM.prefill(cfg, jparams, {"tokens": jnp.asarray(prompt)})
    tl, traw, _ = M.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)})
    assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jk = np.asarray(jraw[0]["mixer"][0])
    for i, (k, _) in enumerate(traw):
        assert_allclose(k.numpy(), jk[i], **TOL)

    L, Hkv, dh, S_max = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 40
    K = rng.standard_normal((L, 3, S_max, Hkv, dh)).astype(np.float32)
    V = rng.standard_normal((L, 3, S_max, Hkv, dh)).astype(np.float32)
    length = np.array([WINDOW - 1, WINDOW, WINDOW + 1], np.int32)
    jc = [{"mixer": jx["attn"].KVCache(
        jnp.asarray(K), jnp.asarray(V),
        jnp.asarray(np.broadcast_to(length, (L, 3))))}]
    tc = [attn.KVCache(torch.from_numpy(K[i].copy()),
                       torch.from_numpy(V[i].copy()), torch.from_numpy(length))
          for i in range(L)]
    jdecode = jax.jit(lambda p, t, c: JM.decode_step(cfg, p, t, c))
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (3, 1))
        jlog, jc = jdecode(jparams, jnp.asarray(tok), jc)
        tlog, tc = M.decode_step(cfg, params, torch.from_numpy(tok), tc)
        assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        assert_same_greedy(tlog.numpy(), np.asarray(jlog))
    jcache = jc[0]["mixer"]
    for i, c in enumerate(tc):
        assert np.array_equal(c.length.numpy(), np.asarray(jcache.length)[i])
        assert_allclose(c.k.numpy(), np.asarray(jcache.k)[i], **TOL)
    assert tc[0].length.tolist() == [WINDOW + 2, WINDOW + 3, WINDOW + 4]


def test_windowed_decode_ignores_rows_before_the_window():
    """Under the window, cache rows before ``length + 1 - window`` add
    nothing: poisoning them leaves the decode logits bit-equal."""
    cfg = small("h2o-danube-3-4b")
    params = lm_params_from_numpy(cfg, lm_tree_from_seed(cfg, 5),
                                  device="cpu")
    rng = np.random.default_rng(6)
    L, Hkv, dh, S_max, n = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, 48, 30
    K = rng.standard_normal((3, S_max, Hkv, dh)).astype(np.float32)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1)))

    def run(poison):
        k = torch.from_numpy(K.copy())
        if poison:
            k[:, :n + 1 - WINDOW] = 1e4
        caches = [attn.KVCache(k.clone(), k.clone(),
                               torch.full((3,), n, dtype=torch.int32))
                  for _ in range(L)]
        return M.decode_step(cfg, params, tok, caches)[0]

    assert torch.equal(run(False), run(True))


@pytest.mark.parametrize("arch", ARCHS)
def test_batcher_tokens_equal_reference(jx, arch):
    """5 requests through 2 slots with prompts of 6 and 20 tokens (past the
    window) and 12 new tokens each: the greedy tokens equal the
    reference's."""
    cfg = small(arch)
    jparams, params = _both(jx, cfg, 7)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 6, 20, 6, 20)]

    def serve(cls, req, p):
        b = cls(cfg, p, slots=2, s_max=40)
        for rid, pr in enumerate(prompts):
            b.submit(req(rid=rid, prompt=pr, max_new_tokens=12))
        return {r.rid: list(map(int, r.out_tokens)) for r in b.run()}

    got = serve(ContinuousBatcher, Request, params)
    want = serve(jx["batching"].ContinuousBatcher, jx["batching"].Request,
                 jparams)
    assert got == want
    assert all(len(t) == 12 for t in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_entry_point_takes_the_variants(arch, capsys):
    from repro_torch.launch import serve

    done = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "2", "--max-new", "3", "--layers", "3"])
    assert sorted(r.rid for r in done) == [0, 1]
    assert all(len(r.out_tokens) == 3 for r in done)
    assert "2 requests" in capsys.readouterr().out


def test_weight_bytes_counts_the_matrices():
    """``flops.weight_bytes`` (the entry point's fit check) is the parameter
    count without norm gains and biases, times the dtype's size; full
    command-r-plus-104b needs ~214 GB, its 4-layer cut ~25 GB."""
    for arch in ARCHS:
        cfg = small(arch)
        params = M.init_model(cfg, device="cpu")
        small_leaves = sum(t.numel() for lyr in params["layers"]
                           for blk in lyr.values() for t in
                           (blk.values() if isinstance(blk, dict) else [blk])
                           if t.dim() == 1)
        small_leaves += params["final_norm"].numel()
        assert flops.weight_bytes(cfg) == 4 * (M.count_params(params)
                                           - small_leaves)
    full = get_config("command-r-plus-104b")
    assert 200e9 < flops.weight_bytes(full) < 220e9
    assert 20e9 < flops.weight_bytes(dataclasses.replace(full, n_layers=4)) < 30e9
