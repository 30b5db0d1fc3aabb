"""The port's counter PRNG and key algebra against the JAX reference: every
value bit-identical (uint32 hashes, f32 uniforms, Poisson draws, threefry
keys, slot tables and lane seeds)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fused as jfused
from repro.core import sampling as jsampling
from repro.kernels import prng as jprng
from repro_torch.core import fused as tfused
from repro_torch.core import keys as tkeys
from repro_torch.core import sampling as tsampling
from repro_torch.kernels import prng as tprng


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per test worker keeps
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_EDGE = np.asarray([0, 1, 2, 255, 256, 65535, 0x7FFFFFFF, 0x80000000,
                    0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _grid():
    rng = np.random.default_rng(7)
    vals = np.concatenate([_EDGE, rng.integers(0, 2**32, 22, dtype=np.uint64)
                           .astype(np.uint32)])
    s, r, c = np.meshgrid(vals[:12], vals, vals[::3], indexing="ij")
    return s.ravel(), r.ravel(), c.ravel()


def _t(a):
    """uint32 values as the port carries them: int64 tensors."""
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))


def test_mix32_and_hash3_bit_identical():
    s, r, c = _grid()
    want_mix = np.asarray(jprng.mix32(jnp.asarray(r)))
    assert np.array_equal(tprng.mix32(_t(r)).numpy().astype(np.uint32),
                          want_mix)
    want = np.asarray(jprng.hash3(jnp.asarray(s), jnp.asarray(r),
                                  jnp.asarray(c)))
    got = tprng.hash3(_t(s), _t(r), _t(c)).numpy()
    assert got.min() >= 0 and got.max() < 2**32
    assert np.array_equal(got.astype(np.uint32), want)


def test_uniform_and_poisson_bit_identical():
    s, r, c = _grid()
    bits = jprng.hash3(jnp.asarray(s), jnp.asarray(r), jnp.asarray(c))
    tbits = tprng.hash3(_t(s), _t(r), _t(c))
    u_j = np.asarray(jprng.uniform01(bits))
    u_t = tprng.uniform01(tbits).numpy()
    assert u_t.dtype == np.float32 and np.array_equal(u_t, u_j)
    assert np.array_equal(tprng.poisson1_from_uniform(tprng.uniform01(tbits))
                          .numpy(), np.asarray(jprng.poisson1_from_uniform(
                              jprng.uniform01(bits))))
    w_j = np.asarray(jprng.poisson1_weights_at(
        jnp.asarray(s), jnp.asarray(r), jnp.asarray(c)))
    assert np.array_equal(tprng.poisson1_weights_at(_t(s), _t(r), _t(c))
                          .numpy(), w_j)


def test_poisson_thresholds_compare_as_f32():
    """The ladder thresholds are the reference's, compared as f32: a
    uniform equal to the f32-rounded threshold counts, one ulp below does
    not."""
    assert tuple(tprng.POISSON1_CDF) == tuple(jprng.POISSON1_CDF)
    for c in jprng.POISSON1_CDF:
        c32 = np.float32(c)
        below = np.nextafter(c32, np.float32(0))
        u = np.asarray([below, c32], np.float32)
        assert np.array_equal(
            tprng.poisson1_from_uniform(torch.from_numpy(u)).numpy(),
            np.asarray(jprng.poisson1_from_uniform(jnp.asarray(u))))


def _ladder_edges():
    """Hashes whose top 24 bits lie at every threshold K - 1, K, K + 1,
    with the low byte 0 and 255, plus the ends of the range."""
    v = np.asarray([k + d for k in tprng.POISSON1_K for d in (-1, 0, 1)]
                   + [0, 1, 2 ** 23 - 1, 2 ** 23, 2 ** 24 - 1], np.int64)
    return np.concatenate([v << 8, (v << 8) + 255])


@pytest.mark.parametrize("case", ["thresholds", "random", "jax"])
def test_kernel_ladder_equals_uniform_ladder(case):
    """The kernels' draw (``poisson1_from_bits``: saturated f32 differences
    on the top 24 bits, no int->float convert) equals the reference's
    ``poisson1_from_uniform(uniform01(h))`` at every threshold +-1 and on
    random hashes, and ``K = ceil(c * 2**24)`` for each f32 threshold c."""
    for k, c in zip(tprng.POISSON1_K, tprng.POISSON1_CDF_F32):
        assert (k - 1) * 2.0 ** -24 < c <= k * 2.0 ** -24
    if case == "thresholds":
        h = torch.from_numpy(_ladder_edges())
    elif case == "random":
        h = torch.from_numpy(np.random.default_rng(3).integers(
            0, 2 ** 32, 2_000_000, dtype=np.uint64).astype(np.int64))
    else:
        s, r, c = _grid()
        h = tprng.hash3(_t(s), _t(r), _t(c))
    got = tprng.poisson1_from_bits(h)
    assert torch.equal(got, tprng.poisson1_from_uniform(tprng.uniform01(h)))
    if case == "jax":
        want = jprng.poisson1_from_uniform(jprng.uniform01(
            jnp.asarray(h.numpy().astype(np.uint32))))
        assert np.array_equal(got.numpy(), np.asarray(want))
    if case == "thresholds":         # each count 0..10 is reached
        assert set(got.tolist()) == set(float(i) for i in range(11))


@pytest.mark.parametrize("seed", [0, 1, 7, 0x5A17, 2**31 - 1, -1, -12345])
def test_prng_key_matches_jax(seed):
    assert np.array_equal(tkeys.prng_key(seed),
                          np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [0, 3, 42, 2**31 - 1])
def test_fold_in_split_bits_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    kn = np.asarray(key)
    for data in (0, 1, 5, 0xB007, 0x5A17, 0x7F4A7C15, 2**32 - 1):
        assert np.array_equal(tkeys.fold_in(kn, data),
                              np.asarray(jax.random.fold_in(key, data)))
    for num in (2, 3, 4, 9, 64):
        assert np.array_equal(tkeys.split(kn, num),
                              np.asarray(jax.random.split(key, num)))
    assert tkeys.bits(kn) == int(jax.random.bits(key, (), jnp.uint32))
    assert np.array_equal(tkeys.bits(kn, 6),
                          np.asarray(jax.random.bits(key, (6,), jnp.uint32)))


def test_split_chain_matches_jax():
    """The session's key walk: repeated ``key, *ks = split(key, m)``."""
    jk, tk = jax.random.PRNGKey(0), tkeys.prng_key(0)
    for m in (2, 4, 8, 3):
        jk, *jks = jax.random.split(jk, m)
        ks = tkeys.split(tk, m)
        tk = ks[0]
        assert np.array_equal(tk, np.asarray(jk))
        assert np.array_equal(ks[1:], np.asarray(jks))


@pytest.mark.parametrize("n_cap", [1 << 10, 1 << 13])
def test_counter_slot_table_matches(n_cap):
    offsets = np.asarray([0, 60_000, 60_013, 160_000, 160_001])
    starts, sizes = offsets[:-1], np.diff(offsets)
    for seed in (0, 7, 0x5A17):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jsampling.counter_slot_table(
            key, starts, sizes, n_cap))
        got = tsampling.counter_slot_table(
            np.asarray(key), starts, sizes, n_cap, device="cpu")
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)


def test_lane_boot_seed_and_tick_seeds_match():
    keys = jax.random.split(jax.random.PRNGKey(11), 5)
    base_j = np.asarray(jax.vmap(jfused.lane_boot_seed)(keys))
    base_t = np.asarray([tfused.lane_boot_seed(k) for k in np.asarray(keys)])
    assert np.array_equal(base_t.astype(np.uint32), base_j)
    # Per-(tick, group) bootstrap seeds of the step body.
    k = np.asarray([0, 1, 5, 23, 2**31 - 1], np.int32)
    m = 4
    want = np.asarray(jprng.hash3(
        jprng.hash3(jnp.asarray(base_j), jnp.asarray(k).astype(jnp.uint32),
                    jnp.uint32(jfused._SALT_GROUP))[:, None],
        jnp.arange(m, dtype=jnp.uint32)[None, :],
        jnp.uint32(jfused._SALT_GROUP)))
    params = tfused.LaneParams(*([None] * 4), torch.as_tensor(base_t),
                               *([None] * 5))
    got = tfused._bootstrap_seeds(params, torch.as_tensor(k), m).numpy()
    assert np.array_equal(got.astype(np.uint32), want)
