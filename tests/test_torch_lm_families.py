"""The port's MoE, SSM and hybrid decoders against the JAX reference on the
same weights (``lm_tree_from_seed`` carried over by ``lm_params_from_numpy``):
reduced ``granite-moe-1b-a400m`` (8 experts top-2, tied head),
``deepseek-moe-16b`` (shared experts, G = 1), ``rwkv6-7b`` (RWKV6 time and
channel mix, chunk 16) and ``jamba-1.5-large-398b`` (one 8-layer unit: seven
Mamba layers and one attention layer, MoE on every other one), f32.
Teacher-forcing logits and aux loss, prefill caches and recurrent states,
decode steps, the batcher's greedy tokens, and the analytic counts of
``models/flops.py`` for every arch the port registers.

Tolerance: logits, caches and states at rtol/atol 2e-4, as
``tests/test_torch_lm.py`` (f32, different summation orders); the aux loss
at rtol 1e-5; greedy tokens compared where the reference's top-2 logit
margin exceeds 2e-4, and the batcher's tokens exactly.  Prefill followed by
decode agrees with teacher forcing only where no MoE capacity drop occurs,
so that check raises the capacity factor to ``num_experts / top_k`` (an
expert receives at most one entry a token, so ``C >= T`` keeps them all).
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import lm_params_from_numpy, lm_tree_from_seed
from repro_torch.models import flops
from repro_torch.models import model as M
from repro_torch.models.config import reduced_for_smoke
from repro_torch.serve.batching import ContinuousBatcher, Request

TOL = dict(rtol=2e-4, atol=2e-4)
FAMILIES = ["granite-moe-1b-a400m", "deepseek-moe-16b", "rwkv6-7b",
            "jamba-1.5-large-398b"]


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
    from repro.models import flops as jflops
    from repro.models import model as JM
    from repro.models.config import reduced_for_smoke as jreduced
    from repro.serve import batching as jb
    return dict(jax=jax, jnp=jnp, M=JM, flops=jflops, batching=jb,
                get_config=jget_config, reduced=jreduced)


def small(arch: str):
    return reduced_for_smoke(get_config(arch))


def _both(jx, cfg, seed):
    tree = lm_tree_from_seed(cfg, seed)
    return (jx["jax"].tree.map(jx["jnp"].asarray, tree),
            lm_params_from_numpy(cfg, tree, device="cpu"))


def assert_same_greedy(got, want, tol=TOL["atol"]):
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol
    assert clear.any()
    assert np.array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def _leaves(node):
    """Tensors of one layer's cache (KVCache, (k, v), states, dicts)."""
    if isinstance(node, dict):
        for key in sorted(node):
            yield from _leaves(node[key])
    elif isinstance(node, (tuple, list)):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def assert_caches_close(cfg, got, jcaches):
    """The port's per-layer caches against the reference's per-position
    stacks: layer ``i`` is repeat ``i // P`` of position ``i % P``."""
    P = len(cfg.layer_pattern)
    for i, layer in enumerate(got):
        mine = list(_leaves(layer))
        theirs = [np.asarray(t)[i // P] for t in _leaves(jcaches[i % P])]
        assert len(mine) == len(theirs) > 0
        for a, b in zip(mine, theirs):
            assert a.shape == b.shape
            assert_allclose(a.numpy(), b, **TOL)


def test_family_configs_kinds_and_leaves(jx):
    """Each config equals the reference's, full and reduced; layer j takes
    pattern position j % len; the carried tree has the reference's
    parameter count, and in bf16 the MoE/SSM leaves the reference keeps in
    f32 stay f32."""
    for arch in FAMILIES:
        want = jx["get_config"](arch)
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            want)
        assert dataclasses.asdict(small(arch)) == dataclasses.asdict(
            jx["reduced"](want))
    jam = get_config("jamba-1.5-large-398b")
    kinds = M.layer_kinds(jam)
    assert len(kinds) == 72 and kinds[7] == kinds[15] == "attn+moe"
    assert kinds[0] == "mamba+dense" and kinds[1] == "mamba+moe"
    assert set(M.layer_kinds(get_config("rwkv6-7b"))) == {"rwkv"}
    for arch in FAMILIES:
        cfg = small(arch)
        jparams, params = _both(jx, cfg, 0)
        assert M.count_params(params) == jx["M"].count_params(jparams)
        bf = dataclasses.replace(cfg, dtype="bfloat16")
        p16 = lm_params_from_numpy(bf, lm_tree_from_seed(bf, 0),
                                   device="cpu")
        f32 = {"router", "dt_bias", "A_log", "D", "mu", "w0", "u",
               "ln_out", "ln1", "ln2"}
        for path, t in M._leaves(p16["layers"]):
            name = path.rsplit("/", 1)[1]
            assert t.dtype == (torch.float32 if name in f32 else
                               torch.bfloat16), path


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_logits_and_aux_match_reference(jx, arch):
    cfg = small(arch)
    jparams, params = _both(jx, cfg, 1)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32))
    want, jaux = jx["M"].train_logits(cfg, jparams,
                                      {"tokens": jx["jnp"].asarray(tokens)})
    got, aux = M.train_logits(cfg, params, {"tokens": torch.from_numpy(tokens)})
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_same_greedy(got.numpy(), np.asarray(want))
    assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert (float(aux) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_states_and_decode_match_reference(jx, arch):
    """Prefill of 16 tokens (one chunk): logits and every layer's raw cache
    (K/V, Mamba SSM state and conv tail, RWKV wkv state and both shifts);
    then 3 decode steps from the padded caches: logits and caches."""
    jax, jnp, JM = jx["jax"], jx["jnp"], jx["M"]
    cfg = small(arch)
    jparams, params = _both(jx, cfg, 3)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (2, 16))
    jl, jraw, _ = JM.prefill(cfg, jparams, {"tokens": jnp.asarray(prompt)})
    tl, traw, _ = M.prefill(cfg, params, {"tokens": torch.from_numpy(prompt)})
    assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_caches_close(cfg, traw, jraw)
    jc = JM.caches_from_prefill(cfg, jraw, 24)
    tc = M.caches_from_prefill(cfg, traw, 24)
    assert_caches_close(cfg, tc, jc)
    jdecode = jax.jit(lambda p, t, c: JM.decode_step(cfg, p, t, c))
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1))
        jlog, jc = jdecode(jparams, jnp.asarray(tok), jc)
        tlog, tc = M.decode_step(cfg, params, torch.from_numpy(tok), tc)
        assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        assert_same_greedy(tlog.numpy(), np.asarray(jlog))
    assert_caches_close(cfg, tc, jc)


def no_drop(cfg):
    if cfg.moe is None:
        return cfg
    cf = cfg.moe.num_experts / cfg.moe.top_k
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_consistency(arch):
    """Greedy continuation via prefill of 16 tokens, then 16 decode steps
    (Mamba/RWKV recurrences, the decode-attention op), matches teacher
    forcing over the 32 tokens, with nothing dropped."""
    cfg = no_drop(small(arch))
    params = lm_params_from_numpy(cfg, lm_tree_from_seed(cfg, 5),
                                  device="cpu")
    seq = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 16)))
    last, raw, _ = M.prefill(cfg, params, {"tokens": seq})
    caches = M.caches_from_prefill(cfg, raw, S_max=40)
    outs = [last]
    for _ in range(16):
        nxt = last[:, -1].argmax(-1)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
        last, caches = M.decode_step(cfg, params, nxt, caches)
        outs.append(last)
    full, _ = M.train_logits(cfg, params, {"tokens": seq})
    got = torch.cat(outs, dim=1).numpy()
    assert_allclose(got, full[:, 15:].numpy(), **TOL)
    assert_same_greedy(got, full[:, 15:].numpy())


@pytest.mark.parametrize("arch", FAMILIES)
def test_batcher_tokens_equal_reference(jx, arch):
    """6 requests through 2 slots, prompts of 6, 16 and 32 tokens (within
    the chunk rule), 8 new tokens each: the greedy tokens equal the
    reference's batcher's, every cache kind spliced into a slot."""
    cfg = small(arch)
    jparams, params = _both(jx, cfg, 7)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (16, 6, 32, 6, 16, 32)]

    def serve(cls, req, p):
        b = cls(cfg, p, slots=2, s_max=48)
        for rid, pr in enumerate(prompts):
            b.submit(req(rid=rid, prompt=pr, max_new_tokens=8))
        return {r.rid: list(map(int, r.out_tokens)) for r in b.run()}

    got = serve(ContinuousBatcher, Request, params)
    want = serve(jx["batching"].ContinuousBatcher, jx["batching"].Request,
                 jparams)
    assert got == want
    assert all(len(t) == 8 for t in got.values())


def test_batcher_refuses_prompts_that_break_the_chunk_rule():
    for arch, bad in (("rwkv6-7b", 40), ("jamba-1.5-large-398b", 24)):
        cfg = small(arch)
        b = ContinuousBatcher(cfg, M.init_model(cfg, device="cpu"), slots=1,
                              s_max=64)
        with pytest.raises(ValueError, match="chunk"):
            b.submit(Request(rid=0, prompt=np.zeros(bad, np.int32)))
        b.submit(Request(rid=1, prompt=np.zeros(32, np.int32)))
        assert len(b.queue) == 1


def test_check_supported_refuses_only_cross_attention_and_encdec():
    for arch in ARCHS:
        M.check_supported(get_config(arch))
    cfg = small("qwen2-1.5b")
    for bad in (dict(family="vision", cross_attn_stride=5, n_layers=5),
                dict(is_encdec=True)):
        with pytest.raises(NotImplementedError, match="cross-attention"):
            M.init_model(dataclasses.replace(cfg, **bad), device="cpu")


def test_analytic_counts_match_reference(jx):
    """``models/flops.py`` equals the reference's for every arch the port
    registers, full and reduced, and its count equals the parameters of a
    reduced model the port builds."""
    for arch in ARCHS:
        for cfg in (get_config(arch), small(arch)):
            jf = jx["flops"]
            assert flops.count_params_analytic(cfg) == \
                jf.count_params_analytic(cfg)
            assert flops.count_active_analytic(cfg) == \
                jf.count_active_analytic(cfg)
            assert flops.summary(cfg) == jf.summary(cfg)
            for kind in ("train", "prefill", "decode"):
                kw = dict(seq_len=512, global_batch=4, kind=kind)
                assert flops.model_flops(cfg, **kw) == jf.model_flops(cfg,
                                                                      **kw)
        cfg = small(arch)
        assert flops.count_params_analytic(cfg) == M.count_params(
            M.init_model(cfg, device="cpu"))


@pytest.mark.parametrize("arch", FAMILIES)
def test_weight_bytes_cover_every_family(arch):
    """``flops.weight_bytes`` (the entry point's fit check and the decode
    steps' byte bound) counts the matrices: in f32, 4 bytes a parameter
    without the 1-D leaves; in bf16 the f32 matrices (router, RWKV mix and
    bonus) at 4 bytes and the rest at 2."""
    cfg = small(arch)
    params = M.init_model(cfg, device="cpu")
    vec = sum(t.numel() for _, t in M._leaves(params) if t.dim() == 1)
    assert flops.weight_bytes(cfg) == 4 * (M.count_params(params) - vec)
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = M.init_model(bf, device="cpu")
    want = sum(t.numel() * t.element_size() for _, t in M._leaves(p16)
               if t.dim() > 1)
    assert flops.weight_bytes(bf) == want
    full = {"granite-moe-1b-a400m": (2.4e9, 3e9),
            "deepseek-moe-16b": (31e9, 35e9), "rwkv6-7b": (13e9, 15e9),
            "jamba-1.5-large-398b": (780e9, 810e9)}[arch]
    assert full[0] < flops.weight_bytes(get_config(arch)) < full[1]


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_entry_point_takes_the_families(arch, capsys):
    from repro_torch.launch import serve

    done = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "2", "--max-new", "3"])
    assert sorted(r.rid for r in done) == [0, 1]
    assert all(len(r.out_tokens) == 3 for r in done)
    assert "2 requests" in capsys.readouterr().out


def test_serve_entry_point_refuses_bad_depths_and_prompts():
    from repro_torch.launch import serve

    with pytest.raises(SystemExit, match="multiple of its layer pattern"):
        serve.main(["--arch", "jamba-1.5-large-398b", "--smoke", "--device",
                    "cpu", "--layers", "12"])
    with pytest.raises(SystemExit, match="chunk"):
        serve.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu",
                    "--prompt-len", "40"])
    done = serve.main(["--arch", "rwkv6-7b", "--smoke", "--device", "cpu",
                       "--prompt-len", "32", "--requests", "1",
                       "--max-new", "2"])
    assert len(done[0].prompt) == 32
