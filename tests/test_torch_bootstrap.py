"""The Poisson-bootstrap ESTIMATE of the port against the JAX reference:
the plain version of the kernel against the reference's Pallas kernel (run
in interpret mode, as the reference's own tests run it) and its jnp oracle,
the lane-batched ESTIMATE, the port's bit-exact width invariance, and, on a
card, the CUDA kernel against its plain version.

The reference is imported only where a test needs it: the card's machine has
no JAX, and the CUDA case runs there."""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.core import bootstrap as tboot
from repro_torch.core import estimators as t_est
from repro_torch.kernels import resolve_use_kernel
from repro_torch.kernels.poisson_bootstrap import ops as tops
from repro_torch.kernels.poisson_bootstrap import ref as tref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per test worker keeps
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B = 100


@pytest.fixture(scope="module")
def jx():
    """The JAX reference modules (skipped where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import bootstrap as jboot
    from repro.core import estimators as jest
    from repro.kernels.poisson_bootstrap import ops as jops
    from repro.kernels.poisson_bootstrap import ref as jref
    # Jitted: eager lax.map dispatch costs seconds per call on the CPU.
    static = dict(static_argnames=("est", "B", "metric"))
    lanes = dict(
        est=jax.jit(jboot.estimate_error_lanes, **static),
        het=jax.jit(jboot.estimate_error_lanes_het,
                    static_argnames=("B", "metric")),
        sums=jax.jit(jboot.lane_moment_sums, static_argnames=("B",)))
    return dict(jax=jax, jnp=jnp, est=jest, ops=jops, ref=jref, lanes=lanes)


def _inputs(q=2, m=3, n=700, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((q, m, n)) * 2 + 5).astype(np.float32)
    lo = rng.integers(0, n // 4, (q, m))
    hi = lo + rng.integers(1, n - n // 4, (q, m))
    pos = np.arange(n)
    mask = ((pos >= lo[..., None]) & (pos < hi[..., None])).astype(np.float32)
    seeds = rng.integers(0, 2**32, (q, m), dtype=np.uint64).astype(np.uint32)
    return x, mask, seeds


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(
        np.int64 if a.dtype == np.uint32 else a.dtype))


@pytest.mark.parametrize("gated", [False, True])
def test_plain_matches_reference_kernel_and_oracle(jx, gated):
    x, mask, seeds = _inputs()
    act = np.asarray([[1, 1, 1], [0, 0, 0]], bool) if gated else None
    jnp = jx["jnp"]
    jact = None if act is None else jnp.asarray(act)
    want_k = np.asarray(jx["ops"].bootstrap_moments_masked(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(seeds), B,
        lane_active=jact, interpret=True))
    want_r = np.asarray(jx["ref"].bootstrap_moments_masked_ref(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(seeds), B,
        lane_active=jact))
    got = tops.bootstrap_moments_masked(
        _t(x), _t(mask), _t(seeds), B,
        lane_active=None if act is None else torch.from_numpy(act)).numpy()
    assert got.shape == (2, 3, B, 5)
    # M[..., 0] = sum w is a sum of integers: exact in any order.
    assert np.array_equal(got[..., 0], want_r[..., 0])
    for want in (want_k, want_r):
        assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    if gated:
        assert not got[1].any()


def test_lane_moment_sums_and_estimates_match(jx):
    jnp = jx["jnp"]
    x, mask, seeds = _inputs(q=3, m=2, n=1024, seed=3)
    act = np.asarray([True, False, True])
    Mj, Mpj = jx["lanes"]["sums"](
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(seeds), B,
        lane_active=jnp.asarray(act))
    Mt, Mpt = tboot.lane_moment_sums(
        _t(x), _t(mask), _t(seeds), B, use_kernel=False,
        lane_active=torch.from_numpy(act))
    assert_allclose(Mt.numpy(), np.asarray(Mj), rtol=1e-5,
                    atol=1e-5 * float(np.abs(np.asarray(Mj)).max()))
    assert_allclose(Mpt.numpy(), np.asarray(Mpj), rtol=1e-5)
    scale = np.ones((3, 2), np.float32)
    deltas = np.asarray([0.05, 0.1, 0.2], np.float32)
    for name in ("avg", "var", "std"):
        ej, thj = jx["lanes"]["est"](
            jx["est"].get(name), jnp.asarray(x)[..., None], jnp.asarray(mask),
            jnp.asarray(seeds), jnp.asarray(scale), jnp.asarray(deltas), B=B)
        et, tht = tboot.estimate_error_lanes(
            t_est.get(name), _t(x)[..., None], _t(mask), _t(seeds),
            _t(scale), _t(deltas), B=B)
        assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-4)
        assert_allclose(tht.numpy(), np.asarray(thj), rtol=1e-5)
    for metric in ("linf", "l1"):
        ej, _ = jx["lanes"]["est"](
            jx["est"].get("avg"), jnp.asarray(x), jnp.asarray(mask),
            jnp.asarray(seeds), jnp.asarray(scale), jnp.asarray(deltas), B=B,
            metric=metric)
        et, _ = tboot.estimate_error_lanes(
            t_est.get("avg"), _t(x), _t(mask), _t(seeds), _t(scale),
            _t(deltas), B=B, metric=metric)
        assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-4)
    fids = np.asarray([0, 2, 3], np.int32)
    ej, thj = jx["lanes"]["het"](
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(seeds),
        jnp.asarray(fids), jnp.asarray(scale), jnp.asarray(deltas), B=B)
    et, tht = tboot.estimate_error_lanes_het(
        _t(x), _t(mask), _t(seeds), _t(fids), _t(scale), _t(deltas), B=B)
    assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-4)
    assert_allclose(tht.numpy(), np.asarray(thj), rtol=1e-5)


def test_estimator_registry_ids_match(jx):
    fam_j = [e.name for e in jx["est"].moment_family()]
    assert [e.name for e in t_est.moment_family()] == fam_j
    for name in fam_j:
        assert t_est.est_id(name) == jx["est"].est_id(name)
        assert t_est.moment_family_index(name) == \
            jx["est"].moment_family_index(name)
        assert (t_est.get(name).needs_population_scale
                == jx["est"].get(name).needs_population_scale)


def test_quantile_is_linear_interpolation(jx):
    """jnp.quantile and torch.quantile both default to linear
    interpolation; the port's per-row quantile is that formula."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((4, 300)).astype(np.float32)
    q = np.asarray([0.95, 0.9, 0.5, 0.8], np.float32)
    got = tboot.quantile_linear(torch.from_numpy(a), torch.from_numpy(q))
    for i in range(4):
        want_t = torch.quantile(torch.from_numpy(a[i]), float(q[i]))
        want_j = jx["jnp"].quantile(jx["jnp"].asarray(a[i]), q[i])
        assert_allclose(float(got[i]), float(want_t), rtol=1e-6)
        assert_allclose(float(got[i]), float(want_j), rtol=1e-6)


def test_width_invariance_bit_exact():
    """Zero-mask slots appended to the slice change no bit: the fixed-chunk
    summation order depends on absolute slot indices only."""
    x, mask, seeds = _inputs(q=2, m=2, n=1024, seed=5)
    pad = lambda a, w: torch.nn.functional.pad(_t(a), (0, w))
    base = tboot.lane_moment_sums(_t(x), _t(mask), _t(seeds), B,
                                  use_kernel=False)
    for w in (1024, 3072, 1000):
        xw = pad(x, w)
        xw[..., 1024:] = 7.0     # junk beyond the mask is ignored
        got = tboot.lane_moment_sums(xw, pad(mask, w), _t(seeds), B,
                                     use_kernel=False)
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])


def test_gated_equals_ungated_on_active_lanes():
    x, mask, seeds = _inputs(q=3, m=2, n=512, seed=6)
    full = tref.bootstrap_moments_masked_ref(_t(x), _t(mask), _t(seeds), B)
    act = torch.tensor([[True, True], [False, False], [True, False]])
    gated = tref.bootstrap_moments_masked_ref(_t(x), _t(mask), _t(seeds), B,
                                              lane_active=act)
    assert torch.equal(gated[act], full[act])
    assert not gated[~act].any()


def test_resolve_use_kernel():
    assert resolve_use_kernel("auto", "cpu") is False
    assert resolve_use_kernel("auto", "cuda") is True
    assert resolve_use_kernel(False, "cuda") is False
    with pytest.raises(ValueError):
        resolve_use_kernel(True, "cpu")
    with pytest.raises(ValueError):
        resolve_use_kernel("maybe", "cpu")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the kernel equals its plain version bit for bit (same
    summation order), gated == ungated, narrow == wide bucket, and it
    counts its launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, mask, seeds = _inputs(q=4, m=4, n=2048, seed=8)
    dev = torch.device("cuda")
    xt, mt, st = (_t(a).to(dev) for a in (x, mask, seeds))
    act = torch.tensor([True, False, True, True], device=dev)[:, None]
    act = act.expand(4, 4)
    n0 = tops.counter.launches
    got = tops.bootstrap_moments_masked(xt, mt, st, 300, lane_active=act)
    assert tops.counter.launches == n0 + 1
    want = tref.bootstrap_moments_masked_ref(xt, mt, st, 300, lane_active=act)
    assert torch.equal(got, want)
    ungated = tops.bootstrap_moments_masked(xt, mt, st, 300)
    assert torch.equal(ungated[act], got[act])
    buf = torch.zeros((4, 4, 4096), device=dev)
    buf[..., :2048] = xt
    wide = tops.bootstrap_moments_masked(
        buf, torch.nn.functional.pad(mt, (0, 2048)), st, 300, lane_active=act)
    assert torch.equal(wide, got)
    with pytest.raises(ValueError):
        tops.bootstrap_moments_masked(xt, mt, st.to(torch.int32), 300)


def _eager_and_replays(fn):
    """Two eager calls, then two replays of a CUDA graph that captured one
    call: all four equal bit for bit (the replays find the arrival counters
    the calls left at zero).  Returns the eager result."""
    first = fn()
    assert torch.equal(fn(), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    once = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(once, first) and torch.equal(out, once)
    return first


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 31, 300])
@pytest.mark.parametrize("gate", ["none", "bool", "int32"])
def test_cuda_kernel_repeats_and_replays(B, gate):
    """On the card: one launch a call, equal to the plain version bit for
    bit at B = 1, 31 and 300 with stacked windows (most chunks masked out)
    and a partial last chunk; two calls and two graph replays equal; a gate
    (bool, int32, expanded over the groups) reads zeros where it is off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(B)
    q, m, n = 3, 4, 4000
    dev = torch.device("cuda")
    x = torch.from_numpy((rng.standard_normal((q, m, n)) * 2 + 5)
                         .astype(np.float32)).to(dev)
    lo = rng.integers(0, 3, (q, m)) * 1000
    pos = np.arange(n)
    mask = torch.from_numpy(((pos >= lo[..., None])
                             & (pos < lo[..., None] + 1000))
                            .astype(np.float32)).to(dev)
    seeds = torch.from_numpy(rng.integers(0, 2**32, (q, m), dtype=np.uint64)
                             .astype(np.int64)).to(dev)
    lane = torch.tensor([True, False, True], device=dev)
    act = {"none": None, "bool": lane[:, None].expand(q, m),
           "int32": lane.to(torch.int32)[:, None].expand(q, m)}[gate]
    n0 = tops.counter.launches
    got = _eager_and_replays(lambda: tops.bootstrap_moments_masked(
        x, mask, seeds, B, lane_active=act))
    assert tops.counter.launches > n0
    assert torch.equal(got, tref.bootstrap_moments_masked_ref(
        x, mask, seeds, B, lane_active=act))
    if act is not None:
        assert not got[1].any() and got[0].any()
