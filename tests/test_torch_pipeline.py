"""The port's token pipeline (``repro_torch.data.pipeline``) against the
reference's: ``batch_for_step`` tokens and labels bit-equal at V = 64,
32 000 and 151 936 over several steps and seeds, the extras in bf16,
``eval_domains``, and the f32 ``exp`` the inverse CDF takes (``keys.exp_f32``)
bit-equal to XLA's CPU ``exp`` over every input the pipeline can form.

The reference's extras path traces ``jnp.arange(extra_len)`` under its jit
with ``extra_len`` not static, which JAX refuses; its body is run under
``jax.disable_jit()`` for that comparison.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import keys
from repro_torch.data import pipeline
from repro_torch.models.config import ModelConfig

VOCABS = [64, 32_000, 151_936]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.data import pipeline as jp
    return dict(jax=jax, jnp=jnp, pipeline=jp)


@pytest.mark.parametrize("vocab", VOCABS)
def test_exp_equals_xla_exp_on_every_pipeline_input(jx, vocab):
    """Every uniform the pipeline draws is k * 2**-24 (k < 2**24), times
    f32(log V): all 2**24 arguments, bit for bit."""
    jnp = jx["jnp"]
    jexp = jx["jax"].jit(jnp.exp)
    log_v = np.float32(math.log(vocab))
    chunk = 1 << 22
    for k0 in range(0, 1 << 24, chunk):
        k = np.arange(k0, k0 + chunk, dtype=np.float32)
        x = (k * np.float32(2.0 ** -24)) * log_v
        want = np.asarray(jexp(jnp.asarray(x)))
        got = keys.exp_f32(torch.from_numpy(x)).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    # torch's own exp is not XLA's: the reason for the explicit polynomial.
    assert not np.array_equal(torch.exp(torch.from_numpy(x)).numpy(), want)


def test_exp_dense_sweep_of_the_range(jx):
    """A dense sweep of [0, log 151936] beyond the pipeline's grid, and the
    range up to the clamp (88.8)."""
    jnp = jx["jnp"]
    x = np.concatenate([np.linspace(0, math.log(151_936), 1 << 20,
                                    dtype=np.float32),
                        np.linspace(0, 88.8, 1 << 18, dtype=np.float32)])
    want = np.asarray(jx["jax"].jit(jnp.exp)(jnp.asarray(x)))
    got = keys.exp_f32(torch.from_numpy(x)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("vocab", VOCABS)
@pytest.mark.parametrize("seed", [0, 100, 7])
def test_batch_for_step_equals_reference(jx, vocab, seed):
    jnp = jx["jnp"]
    for step in (0, 3, 2 ** 31 + 5):
        want = jx["pipeline"].batch_for_step(
            jnp.uint32(step), global_batch=32, seq_len=65, vocab=vocab,
            seed=seed)
        got = pipeline.batch_for_step(step, global_batch=32, seq_len=65,
                                      vocab=vocab, seed=seed, device="cpu")
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), \
                (vocab, seed, step, k)


@pytest.mark.parametrize("extra", ["frames", "image_embeds"])
def test_extras_equal_reference_in_bf16(jx, extra):
    kw = dict(global_batch=3, seq_len=8, vocab=64, seed=1, extra=extra,
              extra_len=6, extra_dim=16)
    with jx["jax"].disable_jit():
        want = jx["pipeline"].batch_for_step(jx["jnp"].uint32(4), **kw)
    got = pipeline.batch_for_step(4, device="cpu", **kw)
    assert got[extra].dtype == torch.bfloat16
    assert got[extra].shape == (3, 6, 16)
    assert np.array_equal(got[extra].float().numpy(),
                          np.asarray(want[extra].astype(jx["jnp"].float32)))


def test_batch_kwargs_for_families():
    base = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                vocab_size=64)
    assert pipeline.batch_kwargs_for(ModelConfig("a", "dense", **base),
                                     16) == dict(extra=None)
    enc = ModelConfig("b", "encdec", is_encdec=True, **base)
    assert pipeline.batch_kwargs_for(enc, 16) == dict(
        extra="frames", extra_len=16, extra_dim=32)
    vis = ModelConfig("c", "vision", n_frontend_tokens=9, **base)
    assert pipeline.batch_kwargs_for(vis, 16) == dict(
        extra="image_embeds", extra_len=9, extra_dim=32)


def test_batch_is_a_function_of_the_step_alone():
    """A restarted job at step k reproduces batch k (the counterpart of
    tests/test_launch.py's determinism test); other steps differ."""
    kw = dict(global_batch=4, seq_len=16, vocab=100, seed=3, device="cpu")
    b1 = pipeline.batch_for_step(5, **kw)
    b2 = pipeline.batch_for_step(5, **kw)
    b3 = pipeline.batch_for_step(6, **kw)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < 100


def test_eval_domains_equal_reference(jx):
    want = jx["pipeline"].eval_domains(151_936, n_domains=3, n_per=64,
                                       seq_len=32)
    got = pipeline.eval_domains(151_936, n_domains=3, n_per=64, seq_len=32,
                                device="cpu")
    assert len(got) == 3
    for a, b in zip(want, got):
        assert b.shape == (64, 32) and np.array_equal(np.asarray(a),
                                                      b.numpy())
