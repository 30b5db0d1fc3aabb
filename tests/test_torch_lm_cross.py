"""The port's cross-attention, encoder-decoder stack and vision layers
against the JAX reference on the same weights (``lm_tree_from_seed``
carried over by ``lm_params_from_numpy``): ``seamless-m4t-large-v2`` (an
encoder of dense layers run bidirectionally over the frames, a decoder of
``cross`` layers) and ``llama-3.2-vision-90b`` (four dense layers, then an
``xonly`` image layer), both reduced to d 64 (4 query heads of 32, the
kernel's smallest head dimension) with 16 memory tokens, f32.
``cross_kv``/``cross_attention`` alone, ``_bidir_attention``/``_encode``,
teacher forcing, prefill caches (self K/V and cross-KV) and the returned
memory, decode steps after ``caches_from_prefill`` and after
``init_caches(mem_len=16, length=3)``, and the conversion of the
reference's own ``enc``/``dec``/``xattn`` leaves.  On a card, the decode
cross-attention goes through the decode-attention kernel.

Tolerance: logits, caches and memory at rtol/atol 2e-4, as
``tests/test_torch_lm_families.py`` (f32, different summation orders);
greedy tokens compared where the reference's top-2 logit margin exceeds
2e-4.  ``xgate`` is drawn near ``atanh(0.5)``: the reference initialises
it to 0, where a cross branch adds nothing and no comparison would see it.
"""
import dataclasses

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_tree_from_seed
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.models import attention as attn
from repro_torch.models import flops
from repro_torch.models import model as M
from repro_torch.models.config import reduced_for_smoke

TOL = dict(rtol=2e-4, atol=2e-4)
CROSS = ["seamless-m4t-large-v2", "llama-3.2-vision-90b"]
T_MEM = 16


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


def small(arch: str):
    """The reduced config cut to d 64 (4 query heads of 32) and 16 memory
    tokens."""
    return reduced_for_smoke(get_config(arch), d_model=64, d_head=32,
                             d_ff=128, n_frontend_tokens=T_MEM,
                             frontend_dim=64)


def _both(jx, cfg, seed):
    tree = lm_tree_from_seed(cfg, seed)
    return (jx["jax"].tree.map(jx["jnp"].asarray, tree),
            lm_params_from_numpy(cfg, tree, device="cpu"))


def _mem_key(cfg) -> str:
    return "frames" if cfg.is_encdec else "image_embeds"


def _batches(jx, cfg, tokens, seed):
    """The same batch for both packages: tokens and the memory input (B,
    16, d) of N(0, 1) f32."""
    mem = np.random.default_rng(seed).standard_normal(
        (tokens.shape[0], T_MEM, cfg.d_model)).astype(np.float32)
    key, jnp = _mem_key(cfg), jx["jnp"]
    return ({"tokens": jnp.asarray(tokens), key: jnp.asarray(mem)},
            {"tokens": torch.from_numpy(tokens), key: torch.from_numpy(mem)})


def assert_same_greedy(got, want, tol=TOL["atol"]):
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > tol
    assert clear.any()
    assert np.array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])


def _leaves(node):
    """Tensors of one layer's cache (KVCache, (k, v), dicts), keys sorted."""
    if isinstance(node, dict):
        for key in sorted(node):
            yield from _leaves(node[key])
    elif isinstance(node, (tuple, list)):
        for v in node:
            yield from _leaves(v)
    else:
        yield node


def assert_caches_close(cfg, got, jcaches):
    """Per-layer caches against the reference's per-position stacks: layer
    ``i`` is repeat ``i // P`` of position ``i % P`` (P = 1 for enc-dec)."""
    P = 1 if cfg.is_encdec else len(cfg.layer_pattern)
    for i, layer in enumerate(got):
        mine = list(_leaves(layer))
        theirs = [np.asarray(t)[i // P] for t in _leaves(jcaches[i % P])]
        assert len(mine) == len(theirs) > 0
        for a, b in zip(mine, theirs):
            assert a.shape == b.shape
            assert_allclose(a.numpy(), b, **TOL)


def _cross_layer(cfg) -> int:
    return next(i for i, k in enumerate(M.layer_kinds(cfg))
                if M.parse_kind(k)[0] in ("cross", "xonly"))


def test_cross_configs_kinds_and_leaves(jx):
    """Both configs equal the reference's, full and reduced; the decoder's
    kinds; the carried tree has the reference's parameter count, every
    cross leaf in its layer, the f32 leaves f32 in bf16, and
    ``weight_bytes`` counts the built model's matrices."""
    for arch in CROSS:
        want = jx["get_config"](arch)
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
            want)
        assert dataclasses.asdict(reduced_for_smoke(get_config(arch))) == \
            dataclasses.asdict(jx["reduced"](want))
    assert M.layer_kinds(get_config(CROSS[0])) == ["cross"] * 24
    kinds = M.layer_kinds(get_config(CROSS[1]))
    assert len(kinds) == 100 and kinds.count("xonly") == 20
    assert kinds[4] == kinds[99] == "xonly" and kinds[0] == "dense"
    f32 = {"ln1", "ln2", "ln_x", "xgate", "final_norm", "enc_norm"}
    for arch in CROSS:
        cfg = small(arch)
        jparams, params = _both(jx, cfg, 0)
        assert M.count_params(params) == jx["M"].count_params(jparams)
        layers = params["dec"] if cfg.is_encdec else params["layers"]
        for p, kind in zip(layers, M.layer_kinds(cfg)):
            mixer = M.parse_kind(kind)[0]
            assert ("mixer" in p) == (mixer != "xonly")
            assert ("xattn" in p) == (mixer in ("cross", "xonly"))
            if "xattn" in p:
                assert "bq" not in p["xattn"]
                assert 0.2 < float(torch.tanh(p["xgate"])) < 0.8
        bf = dataclasses.replace(cfg, dtype="bfloat16")
        p16 = lm_params_from_numpy(bf, lm_tree_from_seed(bf, 0),
                                   device="cpu")
        for path, t in M._leaves(p16):
            name = path.rsplit("/", 1)[1]
            assert t.dtype == (torch.float32 if name in f32 else
                               torch.bfloat16), path
        for c, p in ((cfg, params), (bf, p16)):
            assert flops.weight_bytes(c) == sum(
                t.numel() * t.element_size() for _, t in M._leaves(p)
                if t.dim() > 1)
    assert 4.0e9 < flops.weight_bytes(get_config(CROSS[0])) < 4.2e9


@pytest.mark.parametrize("arch", CROSS)
@pytest.mark.parametrize("S", [1, 5])
def test_cross_kv_and_cross_attention_match_reference(jx, arch, S):
    """``cross_kv`` over a memory and ``cross_attention`` of S queries over
    it (S = 1: the decode op over every memory position), with and without
    a memory mask, on the first cross layer's weights."""
    cfg = small(arch)
    jparams, params = _both(jx, cfg, 1)
    i = _cross_layer(cfg)
    P = 1 if cfg.is_encdec else len(cfg.layer_pattern)
    stack = jparams["dec"] if cfg.is_encdec else jparams["blocks"]
    jp = jx["jax"].tree.map(lambda t: t[i // P], stack[i % P]["xattn"])
    p = (params["dec"] if cfg.is_encdec else params["layers"])[i]["xattn"]
    rng = np.random.default_rng(2)
    mem = rng.standard_normal((2, T_MEM, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    mask = rng.random((2, T_MEM)) < 0.7
    jnp = jx["jnp"]
    jkv = jx["attn"].cross_kv(jp, cfg, jnp.asarray(mem))
    kv = attn.cross_kv(p, cfg, torch.from_numpy(mem))
    for a, b in zip(kv, jkv):
        assert a.shape == (2, T_MEM, cfg.n_kv_heads, cfg.head_dim)
        assert_allclose(a.numpy(), np.asarray(b), **TOL)
    want = jx["attn"].cross_attention(jp, cfg, jnp.asarray(x), jkv)
    got = attn.cross_attention(p, cfg, torch.from_numpy(x), kv)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jx["attn"].cross_attention(jp, cfg, jnp.asarray(x), jkv,
                                      mem_mask=jnp.asarray(mask))
    got = attn.cross_attention(p, cfg, torch.from_numpy(x), kv,
                               mem_mask=torch.from_numpy(mask))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bidir_attention_and_encode_match_reference(jx):
    """The encoder's bidirectional attention on layer 0's weights, and the
    whole encoder (n_layers dense layers, then ``enc_norm``) over the
    frames."""
    cfg = small(CROSS[0])
    jparams, params = _both(jx, cfg, 3)
    jnp = jx["jnp"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, T_MEM, cfg.d_model)).astype(np.float32)
    jp = jx["jax"].tree.map(lambda t: t[0], jparams["enc"][0]["mixer"])
    want, (jk, jv) = jx["M"]._bidir_attention(jp, cfg, jnp.asarray(x))
    got, (k, v) = M._bidir_attention(params["enc"][0]["mixer"], cfg,
                                     torch.from_numpy(x))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    want = jx["M"]._encode(cfg, jparams, {"frames": jnp.asarray(x)})
    got = M._encode(cfg, params, {"frames": torch.from_numpy(x)})
    assert got.shape == (2, T_MEM, cfg.d_model)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", CROSS)
def test_train_logits_match_reference(jx, arch):
    cfg = small(arch)
    jparams, params = _both(jx, cfg, 5)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 24))
    jb, tb = _batches(jx, cfg, tokens, seed=7)
    want, jaux = jx["M"].train_logits(cfg, jparams, jb)
    got, aux = M.train_logits(cfg, params, tb)
    assert got.shape == (2, 24, cfg.vocab_size)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_same_greedy(got.numpy(), np.asarray(want))
    assert float(aux) == float(jaux) == 0.0
    # The cross branch moves the logits: other memory, other logits.
    tb[_mem_key(cfg)] = -tb[_mem_key(cfg)]
    other, _ = M.train_logits(cfg, params, tb)
    assert float((other - got).abs().max()) > 1e-2


@pytest.mark.parametrize("arch", CROSS)
def test_prefill_caches_memory_and_decode_match_reference(jx, arch):
    """Prefill of 8 tokens: logits, every layer's raw cache (self K/V and
    cross-KV) and the returned memory; then 3 decode steps from
    ``caches_from_prefill`` (the cross-KV passed through): logits and
    caches."""
    jax, jnp, JM = jx["jax"], jx["jnp"], jx["M"]
    cfg = small(arch)
    jparams, params = _both(jx, cfg, 8)
    rng = np.random.default_rng(9)
    jb, tb = _batches(jx, cfg, rng.integers(0, cfg.vocab_size, (2, 8)),
                      seed=10)
    jl, jraw, jmem = JM.prefill(cfg, jparams, jb)
    tl, traw, tmem = M.prefill(cfg, params, tb)
    assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert_allclose(tmem.numpy(), np.asarray(jmem), **TOL)
    assert_caches_close(cfg, traw, jraw)
    jc = JM.caches_from_prefill(cfg, jraw, 16)
    tc = M.caches_from_prefill(cfg, traw, 16)
    assert_caches_close(cfg, tc, jc)
    i = _cross_layer(cfg)
    assert tc[i]["xkv"][0] is traw[i]["xkv"][0]
    jdecode = jax.jit(lambda p, t, c: JM.decode_step(cfg, p, t, c))
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1))
        jlog, jc = jdecode(jparams, jnp.asarray(tok), jc)
        tlog, tc = M.decode_step(cfg, params, torch.from_numpy(tok), tc)
        assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        assert_same_greedy(tlog.numpy(), np.asarray(jlog))
    assert_caches_close(cfg, tc, jc)


@pytest.mark.parametrize("arch", CROSS)
def test_decode_from_init_caches_matches_reference(jx, arch):
    """``init_caches(B, S_max, mem_len=16, length=3)`` (zero K/V and
    cross-KV, the reference's reduced-smoke decode), then 3 decode steps:
    logits finite and equal to the reference's; the cross-KV of the
    default length is ``n_frontend_tokens``."""
    jnp, JM = jx["jnp"], jx["M"]
    cfg = small(arch)
    jparams, params = _both(jx, cfg, 11)
    jc = JM.init_caches(cfg, 2, 24, mem_len=T_MEM, length=3)
    tc = M.init_caches(cfg, 2, 24, mem_len=T_MEM, length=3, device="cpu")
    assert_caches_close(cfg, tc, jc)
    rng = np.random.default_rng(12)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (2, 1))
        jlog, jc = JM.decode_step(cfg, jparams, jnp.asarray(tok), jc)
        tlog, tc = M.decode_step(cfg, params, torch.from_numpy(tok), tc)
        assert tlog.shape == (2, 1, cfg.vocab_size)
        assert torch.isfinite(tlog).all()
        assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    assert_caches_close(cfg, tc, jc)
    full = reduced_for_smoke(get_config(arch))
    c = M.init_caches(full, 1, 8, device="cpu")[_cross_layer(full)]
    assert c["xkv"][0].shape == (1, full.n_frontend_tokens, full.n_kv_heads,
                                 full.head_dim)


@pytest.mark.parametrize("arch", CROSS)
def test_prefill_decode_consistency(arch):
    """Greedy continuation by prefill of 8 tokens and 12 decode steps (the
    decode op over the memory) equals teacher forcing over the 20 tokens
    with the same memory."""
    cfg = small(arch)
    params = lm_params_from_numpy(cfg, lm_tree_from_seed(cfg, 13),
                                  device="cpu")
    rng = np.random.default_rng(14)
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8)))
    mem = {_mem_key(cfg): torch.from_numpy(rng.standard_normal(
        (2, T_MEM, cfg.d_model)).astype(np.float32))}
    last, raw, _ = M.prefill(cfg, params, {"tokens": seq, **mem})
    caches = M.caches_from_prefill(cfg, raw, S_max=24)
    outs = [last]
    for _ in range(12):
        nxt = last[:, -1].argmax(-1)[:, None]
        seq = torch.cat([seq, nxt], dim=1)
        last, caches = M.decode_step(cfg, params, nxt, caches)
        outs.append(last)
    full, _ = M.train_logits(cfg, params, {"tokens": seq, **mem})
    got = torch.cat(outs, dim=1).numpy()
    assert_allclose(got, full[:, 7:].numpy(), **TOL)
    assert_same_greedy(got, full[:, 7:].numpy())


@pytest.mark.parametrize("arch", CROSS)
def test_reference_init_tree_carries_over(jx, arch):
    """The reference's own initial tree (zero ``xgate``, unit gains; the
    ``enc``/``dec`` stacks of an encoder-decoder) converts with the same
    parameter count and teacher-forcing logits, and each ``xattn`` leaf
    lands in its layer."""
    jax = jx["jax"]
    cfg = small(arch)
    jparams = jx["M"].init_model(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    assert M.count_params(params) == jx["M"].count_params(jparams)
    i = _cross_layer(cfg)
    P = 1 if cfg.is_encdec else len(cfg.layer_pattern)
    stack = tree["dec"] if cfg.is_encdec else tree["blocks"]
    layers = params["dec"] if cfg.is_encdec else params["layers"]
    assert np.array_equal(layers[i]["xattn"]["wk"].numpy(),
                          stack[i % P]["xattn"]["wk"][i // P])
    if cfg.is_encdec:
        assert np.array_equal(params["enc"][1]["ff"]["wo"].numpy(),
                              tree["enc"][0]["ff"]["wo"][1])
    tokens = np.random.default_rng(15).integers(0, cfg.vocab_size, (2, 9))
    jb, tb = _batches(jx, cfg, tokens, seed=16)
    want, _ = jx["M"].train_logits(cfg, jparams, jb)
    got, _ = M.train_logits(cfg, params, tb)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", CROSS)
def test_serve_entry_points_refuse_like_the_reference(arch):
    """Both serve entry points refuse the arch with the reference serve
    demo's message."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    from repro_torch.serve.batching import ContinuousBatcher

    with pytest.raises(SystemExit, match="decoder-only archs") as want:
        jserve.main(["--arch", arch, "--smoke"])
    with pytest.raises(SystemExit) as got:
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert str(got.value) == str(want.value)
    cfg = small(arch)
    with pytest.raises(ValueError, match="decoder-only archs"):
        ContinuousBatcher(cfg, M.init_model(cfg, device="cpu"), slots=2,
                          s_max=32)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", CROSS)
def test_cuda_decode_cross_attention_through_the_kernel(arch):
    """On the card: prefill and 6 decode steps equal the CPU's (rtol/atol
    2e-4), the decode's self- and cross-attention both through the
    decode-attention kernel (one launch each a layer and step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = small(arch)
    tree = lm_tree_from_seed(cfg, 17)
    rng = np.random.default_rng(18)
    tokens = rng.integers(0, cfg.vocab_size, (2, 14))
    mem = rng.standard_normal((2, T_MEM, cfg.d_model)).astype(np.float32)
    per_step = sum({"attn": 1, "cross": 2, "xonly": 1}[M.parse_kind(k)[0]]
                   for k in M.layer_kinds(cfg))
    logs = {}
    for dev in ("cuda", "cpu"):
        params = lm_params_from_numpy(cfg, tree, device=dev)
        seq = torch.as_tensor(tokens, device=dev)
        batch = {"tokens": seq[:, :8],
                 _mem_key(cfg): torch.as_tensor(mem, device=dev)}
        last, raw, _ = M.prefill(cfg, params, batch)
        caches = M.caches_from_prefill(cfg, raw, S_max=16)
        out = [last]
        n0 = da_ops.counter.launches
        for t in range(8, 14):
            last, caches = M.decode_step(cfg, params, seq[:, t:t + 1], caches)
            out.append(last)
        launched = da_ops.counter.launches - n0
        assert launched == (6 * per_step if dev == "cuda" else 0)
        logs[dev] = torch.cat(out, dim=1).cpu().numpy()
    assert_allclose(logs["cuda"], logs["cpu"], **TOL)
