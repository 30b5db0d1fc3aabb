"""The port's threefry draws against ``jax.random`` (jax 0.9.0, partitionable
threefry): ``uniform`` and ``randint`` bit for bit, on the host and as torch
ops; ``normal`` through XLA's f32 ``erf_inv``: its ``log1p`` bit for bit
(the rational branch over every f32 in its range, the ``log(1 + x)`` branch
through XLA's CPU ``logf``), and ``normal`` itself bit for bit except in the
tails where ``erf_inv`` takes ``sqrt(w)`` (|normal| above ~2.93), there
within 2 ulps: XLA's CPU ``sqrt`` is not the correctly rounded one torch
computes (ROADMAP Queue 3 item 2); and the host route's draws built on
them: Poisson and multinomial bootstrap weights, stratified samples, the
two-point init design."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bootstrap as jb
from repro.core import sampling as js
from repro.data import make_grouped as j_make_grouped
from repro_torch.core import bootstrap as tb
from repro_torch.core import keys
from repro_torch.core import sampling as ts
from repro_torch.data import make_grouped as t_make_grouped

SHAPES = [(7,), (3, 5), (150, 400), (4, 2048)]


def _u32(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_bit_equal(seed, shape):
    k = jax.random.PRNGKey(seed)
    want = _u32(jax.random.uniform(k, shape))
    assert np.array_equal(_u32(keys.uniform(np.asarray(k), shape)), want)
    got = keys.uniform(np.asarray(k), shape, device="cpu")
    assert got.dtype == torch.float32 and np.array_equal(_u32(got.numpy()),
                                                         want)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    want = _u32(jax.random.uniform(k, shape, jnp.float32, lo, 1.0))
    assert np.array_equal(
        _u32(keys.uniform(np.asarray(k), shape, lo, 1.0, device="cpu")),
        want)


@pytest.mark.parametrize("lo,hi", [(0, 2 ** 31 - 1), (-5, 17), (3, 3),
                                   (-2 ** 31, 2 ** 31 - 1)])
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_randint_bit_equal(lo, hi, shape):
    for seed in (1, 42):
        k = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.randint(k, shape, lo, hi))
        got = keys.randint(np.asarray(k), shape, lo, hi)
        assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(9,), (300, 1), (64, 500)])
def test_normal_within_4_ulps(shape):
    """Bit-equal below the sqrt tail, within 2 ulps in it (tighter than the
    4 the name keeps)."""
    for seed in (0, 5):
        k = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.normal(k, shape))
        got = keys.normal(np.asarray(k), shape).numpy()
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert np.all(np.abs(got - want) <= 2 * ulp)
        assert np.array_equal(got[np.abs(want) < 2.93],
                              want[np.abs(want) < 2.93])


# Every f32 with |x| < sqrt(2) - 1, in eight runs of bit patterns.
_SMALL_HI = int(np.float32(keys.LOG1P_SMALL).view(np.uint32))   # excluded
_CHUNK = 1 << 24


@pytest.mark.parametrize("sign", [0, 0x80000000])
@pytest.mark.parametrize("quarter", range(4))
def test_log1p_rational_branch_exhaustive(sign, quarter):
    """XLA's rational ``log1p`` branch (Horner steps fused, subnormal
    arguments flushed) against ``jnp.log1p``, bit for bit, over every f32 of
    one sign with |x| < sqrt(2) - 1, a quarter of the range a case."""
    edges = np.linspace(0, _SMALL_HI, 5).astype(np.int64)
    for lo in range(int(edges[quarter]), int(edges[quarter + 1]), _CHUNK):
        hi = min(lo + _CHUNK, int(edges[quarter + 1]))
        bits = (np.arange(lo, hi, dtype=np.int64) | sign).astype(np.uint32)
        x = bits.view(np.float32)
        want = np.asarray(jnp.log1p(x)).view(np.uint32)
        got = keys._log1p_small(keys._flush(torch.from_numpy(x)))
        bad = np.nonzero(got.numpy().view(np.uint32) != want)[0]
        assert bad.size == 0, (hex(bits[bad[0]]), bad.size)


def test_log1p_and_log_bit_equal():
    """Both ``log1p`` branches, and XLA's CPU ``logf`` over the positive
    range, subnormals and specials included."""
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.uniform(-1, 1, 1 << 20), rng.uniform(-1, 4, 1 << 20),
        [-1.0, 0.0, -0.0, 1e-45, -1e-45, 1e-40, 0.5, np.inf]]).astype(
            np.float32)
    want = np.asarray(jnp.log1p(x)).view(np.uint32)
    assert np.array_equal(keys.log1p_f32(torch.from_numpy(x)).numpy()
                          .view(np.uint32), want)
    a = (rng.uniform(0.5, 1.0, 1 << 20).astype(np.float32)
         * np.float32(2.0) ** rng.integers(-126, 127, 1 << 20)).astype(
             np.float32)
    a = np.concatenate([a, np.float32([0.0, np.inf, 1.0, 2.0])])
    assert np.array_equal(
        keys.log_f32(torch.from_numpy(a)).numpy().view(np.uint32),
        np.asarray(jnp.log(a)).view(np.uint32))


@pytest.mark.parametrize("shape", [(37, 11), (400, 250), (1000, 2000)])
def test_normal_bit_equal_below_the_sqrt_tail(shape):
    """2-D draws: every value with |normal| < 2.93 (the ``w < 5`` branch of
    ``erf_inv``) bit-equal; the tail within 2 ulps, in fewer than 1e-4 of
    the draws."""
    for seed in (1, 7):
        k = jax.random.PRNGKey(seed)
        want = np.asarray(jax.random.normal(k, shape))
        got = keys.normal(np.asarray(k), shape).numpy()
        body = np.abs(want) < 2.93
        assert np.array_equal(got[body].view(np.uint32),
                              want[body].view(np.uint32))
        ulp = np.spacing(np.abs(want).astype(np.float32))
        assert np.all(np.abs(got - want) <= 2 * ulp)
        assert np.mean(got != want) < 1e-4


def test_random_bits_counter_layout():
    """Entry i of a 2-D draw hashes counter i in row-major order, so a
    flattened draw equals the 1-D draw of the same size."""
    k = np.asarray(jax.random.PRNGKey(9))
    flat = keys.random_bits(k, 24)
    assert np.array_equal(keys.random_bits(k, (4, 6)).ravel(), flat)
    dev = keys.random_bits(k, (4, 6), device="cpu")
    assert dev.dtype == torch.int64 and np.array_equal(
        dev.numpy().ravel().astype(np.uint32), flat)
    assert np.array_equal(flat, np.asarray(jax.random.bits(
        jax.random.PRNGKey(9), (24,))))


@pytest.mark.parametrize("B,n", [(150, 400), (64, 1000)])
def test_bootstrap_weights_bit_equal(B, n):
    k = jax.random.PRNGKey(B + n)
    want = np.asarray(jb.poisson_weights(k, B, n))
    got = tb.poisson_weights(np.asarray(k), B, n, "cpu").numpy()
    assert np.array_equal(got, want)
    mask = (np.arange(n) < n - 37).astype(np.float32)
    want = np.asarray(jb.multinomial_weights(k, B, jnp.asarray(mask)))
    got = tb.multinomial_weights(np.asarray(k), B,
                                 torch.from_numpy(mask)).numpy()
    assert np.array_equal(got, want)
    assert np.all(got.sum(1) == n - 37)


def test_stratified_sample_and_init_design_equal():
    jd = j_make_grouped(["normal", "exp", "uniform"], 5_000, seed=4)
    td = t_make_grouped(["normal", "exp", "uniform"], 5_000, seed=4,
                        device="cpu")
    k = js.root_key(11)
    assert np.array_equal(ts.root_key(11), np.asarray(k))
    n_vec = np.asarray([100, 700, 1024])
    sj, mj = js.stratified_sample(k, jd.values, jnp.asarray(jd.offsets),
                                  jnp.asarray(n_vec), 1024)
    st, mt = ts.stratified_sample(np.asarray(k), td.values, td.offsets,
                                  n_vec, 1024)
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert np.array_equal(mt.numpy(), np.asarray(mj))
    hj = js.stratified_sample_host(np.random.default_rng(5), jd, n_vec, 1024)
    ht = ts.stratified_sample_host(np.random.default_rng(5), td, n_vec, 1024)
    for a, b in zip(ht, hj):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for m, l, lo, hi in ((2, 6, 400, 800), (4, 16, 1000, 2000),
                         (9, 11, 100, 200)):
        sub = jax.random.split(k)[1]
        want = js.two_point_init_sizes(sub, m, l, lo, hi)
        got = ts.two_point_init_sizes(np.asarray(sub), m, l, lo, hi)
        assert np.array_equal(got, want)
