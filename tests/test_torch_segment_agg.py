"""The port's two segment kernels against the JAX reference: the plain
versions of the exact GROUP BY aggregate and of the segment bootstrap
against the reference's oracle and its Pallas kernel (run in interpret
mode, as the reference's own tests run it), the segment bootstrap's
summation order against the Poisson-bootstrap kernel's, and, on a card, each
CUDA kernel against its plain version.

Tolerances: the aggregate's sums are held at the reference's own
kernel-vs-oracle tolerance (rtol 2e-4, atol 2e-3; segment_sum and the port
add f32 in different orders), min/max and counts exactly; the segment
bootstrap at rtol 1e-5 with atol 1e-4 for sums of signed terms near zero.

The reference is imported only where a test needs it: the card's machine has
no JAX, and the CUDA cases run there."""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.kernels import prng
from repro_torch.kernels.poisson_bootstrap import ref as pb_ref
from repro_torch.kernels.segment_agg import ops, ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per test worker keeps
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    """The JAX reference modules (skipped where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.segment_agg import ops as jops
    from repro.kernels.segment_agg import ref as jref
    return dict(jnp=jnp, ops=jops, ref=jref)


def _agg_case(n, m, seed):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, m, n).astype(np.int32)
    x = rng.standard_normal(n).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.05).astype(np.float32)
    return gid, x, mask


def _np_aggregate(gid, x, mask, m):
    """float64 per-group sums, and exact min/max over mask > 0."""
    x64, w = x.astype(np.float64), mask.astype(np.float64)
    out = {k: np.bincount(gid, weights=w * x64 ** p, minlength=m)
           for p, k in enumerate(ref.AGG_KEYS)}
    live = [x[(gid == g) & (mask > 0)] for g in range(m)]
    out["min"] = np.asarray([v.min() if v.size else ref.BIG for v in live])
    out["max"] = np.asarray([v.max() if v.size else -ref.BIG for v in live])
    return out


@pytest.mark.parametrize("n,m", [(5000, 5), (20000, 300)])
def test_segment_aggregate_matches_reference(jx, n, m):
    gid, x, mask = _agg_case(n, m, seed=n + m)
    got = ops.segment_aggregate(torch.from_numpy(gid), torch.from_numpy(x),
                                torch.from_numpy(mask), m)
    jnp = jx["jnp"]
    want = jx["ref"].segment_aggregate_ref(
        jnp.asarray(gid), jnp.asarray(x), jnp.asarray(mask), m)
    exact = _np_aggregate(gid, x, mask, m)
    assert got["count"].shape == (m,)
    for k in ref.AGG_KEYS:
        assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-4,
                        atol=2e-3, err_msg=k)
        assert_allclose(got[k].numpy(), exact[k], rtol=2e-4, atol=2e-3,
                        err_msg=k)
    assert np.array_equal(got["count"].numpy(), np.asarray(want["count"]))
    nonempty = exact["count"] > 0
    assert nonempty.all()
    for k in ("min", "max"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
        assert np.array_equal(got[k].numpy(), exact[k].astype(np.float32)), k


def test_segment_aggregate_many_tiles_and_foreign_ids():
    """Three block tiles; ids outside [0, m) and zero masks count nowhere;
    an empty group reads 0 sums and the +-3e38 sentinels."""
    n, m = 2 * ref.AGG_TILE + 4321, 9
    gid, x, mask = _agg_case(n, m, seed=3)
    gid[::97] = m + 3
    gid[::101] = -1
    gid[gid == 4] = 5                       # group 4 empty
    got = ops.segment_aggregate(torch.from_numpy(gid.astype(np.int64)),
                                torch.from_numpy(x), torch.from_numpy(mask), m)
    keep = (gid >= 0) & (gid < m)
    exact = _np_aggregate(gid[keep], x[keep], mask[keep], m)
    for k in ref.AGG_KEYS:
        assert_allclose(got[k].numpy(), exact[k], rtol=1e-5, atol=1e-3,
                        err_msg=k)
    for k in ("min", "max"):
        assert np.array_equal(got[k].numpy(), exact[k].astype(np.float32)), k
    assert float(got["count"][4]) == 0.0 and float(got["sum4"][4]) == 0.0
    assert float(got["min"][4]) == np.float32(ref.BIG)
    assert float(got["max"][4]) == -np.float32(ref.BIG)


def _boot_case(seed, n, m):
    """The reference test's packed-stream case: unique absolute slots per
    lane, a per-lane seed carried by every element."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, m, n).astype(np.int32)
    slot = np.empty(n, np.int32)
    for g in range(m):
        idx = np.flatnonzero(gid == g)
        slot[idx] = np.arange(len(idx)) + 10000 * g
    x = rng.standard_normal(n).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.1).astype(np.float32)
    seed_el = np.uint32(0xABC) + gid.astype(np.uint32) * np.uint32(977)
    return gid, slot, x, mask, seed_el


def _tt(*arrs):
    return [torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                             else a) for a in arrs]


@pytest.mark.parametrize("n,m,B", [(2048, 3, 64), (999, 8, 100)])
def test_segment_bootstrap_matches_reference_kernel(jx, n, m, B):
    gid, slot, x, mask, seed = _boot_case(n + m, n, m)
    got = ops.segment_bootstrap_moments(*_tt(gid, slot, x, mask, seed), m, B)
    jnp = jx["jnp"]
    want = jx["ops"].segment_bootstrap_moments(
        jnp.asarray(gid), jnp.asarray(slot), jnp.asarray(x),
        jnp.asarray(mask), jnp.asarray(seed), m, B, interpret=True)
    assert got.shape == (m, B, 3)
    assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_segment_bootstrap_matches_direct_poisson_weights():
    """Each lane's sums equal a naive computation with the same counter
    weights w = poisson1(hash3(seed, slot, b))."""
    n, m, B = 1500, 4, 32
    gid, slot, x, mask, seed = _boot_case(42, n, m)
    got = ops.segment_bootstrap_moments(*_tt(gid, slot, x, mask, seed), m,
                                        B).numpy()
    w = prng.poisson1_weights_at(
        torch.from_numpy(seed.astype(np.int64))[:, None],
        torch.from_numpy(slot.astype(np.int64))[:, None],
        torch.arange(B)[None, :]).numpy().astype(np.float64)
    for g in range(m):
        sel = (gid == g) & (mask > 0)
        for p in range(3):
            want = (w[sel] * (x[sel].astype(np.float64) ** p)[:, None]).sum(0)
            assert_allclose(got[g, :, p], want, rtol=1e-5, atol=1e-4,
                            err_msg=f"lane {g} moment {p}")


def _windows(q, n, seed):
    """A (q, n) buffer with one live window [lo, hi) per lane (lane 1 with
    none) and the packed stream of those windows."""
    rng = np.random.default_rng(seed)
    buf = (rng.standard_normal((q, n)) * 3 + 2).astype(np.float32)
    lo = rng.integers(0, n // 2, q)
    hi = lo + rng.integers(1, n // 2, q)
    hi[1] = lo[1]
    seeds = rng.integers(0, 2**32, q, dtype=np.uint64).astype(np.int64)
    gid = np.concatenate([np.full(h - l, g) for g, (l, h)
                          in enumerate(zip(lo, hi))])
    slot = np.concatenate([np.arange(l, h) for l, h in zip(lo, hi)])
    return buf, lo, hi, seeds, gid, slot


def test_block_lane_sums_equal_poisson_bootstrap_bit_exact():
    """The segment bootstrap adds in the Poisson-bootstrap kernel's order
    (absolute 256-slot chunks, ascending), so each lane's sums equal the
    per-lane kernel's on the same window in every bit; a lane with no
    window reads zeros."""
    q, n, B = 5, 1500, 64
    buf, lo, hi, seeds, gid, slot = _windows(q, n, seed=4)
    x = buf[gid, slot]
    off = torch.as_tensor(np.searchsorted(gid, np.arange(q + 1)))
    got = ops.segment_bootstrap_sorted(
        torch.from_numpy(x), torch.ones(len(x)), torch.from_numpy(slot),
        torch.from_numpy(seeds[gid]), off, B, int(hi.max()))
    pos = np.arange(n)
    mask = ((pos >= lo[:, None]) & (pos < hi[:, None])).astype(np.float32)
    want = pb_ref.bootstrap_moments_masked_ref(
        torch.from_numpy(buf), torch.from_numpy(mask),
        torch.from_numpy(seeds), B)[..., :3]
    assert torch.equal(got, want)
    assert not got[1].any()


def test_unsorted_stream_equals_sorted_call_bit_exact():
    """The op's stable sort is a permutation only: a shuffled stream gives
    the sorted call's sums in every bit, and foreign lane ids add nothing."""
    q, n, B = 4, 900, 40
    buf, lo, hi, seeds, gid, slot = _windows(q, n, seed=9)
    x = buf[gid, slot]
    off = torch.as_tensor(np.searchsorted(gid, np.arange(q + 1)))
    want = ops.segment_bootstrap_sorted(
        torch.from_numpy(x), torch.ones(len(x)), torch.from_numpy(slot),
        torch.from_numpy(seeds[gid]), off, B, int(hi.max()))
    perm = np.random.default_rng(1).permutation(len(x))
    gid_f = np.concatenate([gid[perm], [q, -2]])
    got = ops.segment_bootstrap_moments(
        *_tt(gid_f, np.concatenate([slot[perm], [3, 5]]),
             np.concatenate([x[perm], [1e6, 1e6]]).astype(np.float32),
             np.ones(len(x) + 2, np.float32),
             np.concatenate([seeds[gid][perm], [1, 2]]).astype(np.uint32)),
        q, B)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        ops.segment_bootstrap_moments(*_tt(gid, slot - 1000, x,
                                           np.ones(len(x), np.float32),
                                           seeds[gid].astype(np.uint32)), q, B)


def _plan_case(case):
    """(lane_off, slot, n_slots) of a sorted packed stream."""
    rng = np.random.default_rng(len(case))
    if case == "stacked":            # the grouped serve's init probes
        lanes = [np.arange(3000, 4000)] * 9
    elif case == "empty_lanes":
        lanes = [np.arange(5, 700), np.arange(0), np.arange(256, 513),
                 np.arange(0)]
    elif case == "one_element":
        lanes = [np.asarray([777]), np.arange(100, 140)]
    elif case == "chunk_edge":
        lanes = [np.arange(250, 262), np.arange(511, 769)]
    elif case == "sparse":
        lanes = [np.sort(rng.choice(20000, n, replace=False))
                 for n in (1, 40, 300, 2000)]
    elif case == "repeated":         # last - first == count - 1, not contiguous
        lanes = [np.asarray([0, 0, 2]), np.asarray([254, 255, 255, 256, 258]),
                 np.repeat(np.arange(300, 400), 3)]
    elif case == "q1":
        lanes = [np.arange(1000, 1700)]
    else:                            # more lanes than a block plans itself
        lanes = [np.sort(rng.choice(4096, rng.integers(0, 6), replace=False))
                 for _ in range(ops.PLAN_LANES + 88)]
    off = np.concatenate([[0], np.cumsum([len(v) for v in lanes])])
    slot = np.concatenate(lanes).astype(np.int32) if off[-1] else \
        np.zeros(0, np.int32)
    return off, slot, int(slot.max()) + 1 if slot.size else 1


_PLAN_CASES = ["stacked", "empty_lanes", "one_element", "chunk_edge",
               "sparse", "repeated", "q1", "many_lanes"]


@pytest.mark.parametrize("case", _PLAN_CASES)
def test_seg_plan_covers_each_element_once(case):
    """Every element of every lane lies in exactly one item, the item of
    its own chunk; a lane's items are consecutive, in ascending chunk order
    from its first slot's chunk to its last's; no item of a contiguous lane
    is empty."""
    off, slot, n_slots = _plan_case(case)
    base, items = ops.seg_plan(off, slot, n_slots)
    q = len(off) - 1
    assert len(base) == q + 1 and base[0] == 0 and base[-1] == len(items)
    for g in range(q):
        a, e = off[g], off[g + 1]
        mine = items[base[g]:base[g + 1]]
        assert all(it[0] == g for it in mine)
        if a == e:
            assert not mine
            continue
        chunks = [it[1] for it in mine]
        assert chunks == list(range(slot[a] >> 8, (slot[e - 1] >> 8) + 1))
        cover = np.concatenate([np.arange(lo, hi) for _, _, lo, hi in mine])
        assert np.array_equal(cover, np.arange(a, e))
        for _, c, lo, hi in mine:
            assert np.all(slot[lo:hi] >> 8 == c)
        if np.array_equal(slot[a:e], np.arange(slot[a], slot[a] + e - a)):
            assert all(hi > lo for _, _, lo, hi in mine)


@pytest.mark.parametrize("case", _PLAN_CASES)
def test_seg_grid_depends_on_host_values_only(case):
    """The grid is a function of (L, q, n_slots, B, SMs): the same for any
    stream with those values; its tiles cover B; and at the grouped serve's
    shape it puts at least one unit of work on every SM."""
    off, slot, n_slots = _plan_case(case)
    L, q = int(off[-1]), len(off) - 1
    for B in (1, 31, 300):
        blocks, warps, tiles = ops.seg_grid(L, q, n_slots, B, 132)
        assert (blocks, warps, tiles) == ops.seg_grid(L, q, n_slots, B, 132)
        assert 1 <= warps <= 16 and (warps - 1) * tiles * 32 < B
        assert warps * tiles * 32 >= B
        assert 1 <= blocks <= 132 * max(1, 32 // warps)
    if case == "stacked":
        blocks, warps, tiles = ops.seg_grid(L, q, n_slots, 300, 132)
        assert len(ops.seg_plan(off, slot, n_slots)[1]) * tiles >= 132


@pytest.mark.parametrize("case", ["stacked", "sparse", "repeated",
                                  "empty_lanes"])
def test_kernel_arithmetic_on_the_plan_equals_plain_bit_exact(case):
    """The kernel's arithmetic, emulated on the CPU: per item of
    ``seg_plan``, draws from ``prng.poisson1_from_bits`` of the staged keys
    added one element at a time in stream order (masked elements add exact
    zeros), then each lane's items in order -- equal to the plain version
    in every bit."""
    off, slot, n_slots = _plan_case(case)
    rng = np.random.default_rng(5)
    L, q, B = int(off[-1]), len(off) - 1, 24
    x = torch.from_numpy(rng.standard_normal(L).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=L) > 0.2).astype(np.float32))
    seed = torch.from_numpy(rng.integers(0, 2**32, L, dtype=np.uint64)
                            .astype(np.int64))
    sl = torch.from_numpy(slot.astype(np.int64))
    feats = ref.boot_features(x, mask)
    b = torch.arange(B, dtype=torch.int64)
    base, items = ops.seg_plan(off, slot, n_slots)
    out = torch.zeros((q, B, 3))
    for g, c, lo, hi in items:
        acc = torch.zeros((B, 3))
        for j in range(lo, hi):
            w = prng.poisson1_from_bits(prng.hash3(seed[j], sl[j], b))
            acc = acc + w[:, None] * feats[j]
        out[g] = out[g] + acc
    want = ref.segment_bootstrap_sorted_ref(
        x, mask, sl, seed, torch.from_numpy(off), B, n_slots)
    assert torch.equal(out, want)


def test_cpu_tensors_take_the_plain_versions():
    gid, x, mask = _agg_case(300, 3, seed=0)
    a0, b0 = ops.agg_counter.launches, ops.boot_counter.launches
    ops.segment_aggregate(*_tt(gid, x, mask), 3)
    ops.segment_bootstrap_moments(*_tt(*_boot_case(0, 300, 3)), 3, 16)
    assert (ops.agg_counter.launches, ops.boot_counter.launches) == (a0, b0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On the card: both kernels equal their plain versions bit for bit
    (same summation order) and count their launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for n, m in ((5000, 5), (2 * ref.AGG_TILE + 77, 300)):
        gid, x, mask = _agg_case(n, m, seed=n)
        args = [t.to(dev) for t in _tt(gid, x, mask)]
        a0 = ops.agg_counter.launches
        got = ops.segment_aggregate(*args, m)
        assert ops.agg_counter.launches == a0 + 1
        want = ref.segment_aggregate_ref(*args, m)
        for k in want:
            assert torch.equal(got[k], want[k]), (n, m, k)
    q, B = 6, 300
    buf, lo, hi, seeds, gid, slot = _windows(q, 5000, seed=2)
    x = torch.from_numpy(buf[gid, slot]).to(dev)
    args = (x, torch.ones_like(x), torch.from_numpy(slot).to(dev),
            torch.from_numpy(seeds[gid]).to(dev),
            torch.as_tensor(np.searchsorted(gid, np.arange(q + 1)),
                            device=dev), B, int(hi.max()))
    b0 = ops.boot_counter.launches
    got = ops.segment_bootstrap_sorted(*args)
    assert ops.boot_counter.launches == b0 + 1
    assert torch.equal(got, ref.segment_bootstrap_sorted_ref(*args))
    assert not got[1].any()


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


def _mixed_stream(q, B, seed):
    """A sorted packed stream of q lanes: stacked contiguous windows, sparse
    and repeated slots, empty lanes and a masked-out lane (lane 1)."""
    rng = np.random.default_rng(seed)
    lanes = []
    for g in range(q):
        kind = g % 6
        if kind == 0:
            k = rng.integers(0, 7)
            lanes.append(np.arange(1000 * k, 1000 * k + 1000))
        elif kind == 1:
            lanes.append(np.arange(300, 300 + rng.integers(1, 600)))
        elif kind == 2:
            lanes.append(np.sort(rng.choice(8192, rng.integers(1, 50),
                                            replace=False)))
        elif kind == 3:
            lanes.append(np.repeat(np.arange(250, 260), 2))
        elif kind == 4:
            lanes.append(np.arange(0))
        else:
            lanes.append(np.arange(250, 250 + rng.integers(1, 20)))
    off = np.concatenate([[0], np.cumsum([len(v) for v in lanes])])
    slot = np.concatenate(lanes).astype(np.int32)
    L = len(slot)
    x = (rng.standard_normal(L) * 3 + 2).astype(np.float32)
    mask = (rng.uniform(size=L) > 0.1).astype(np.float32)
    mask[off[1]:off[2]] = 0.0
    seeds = rng.integers(0, 2**32, q, dtype=np.uint64).astype(np.int64)
    gid = np.repeat(np.arange(q), np.diff(off))
    dev = torch.device("cuda")
    return (torch.from_numpy(x).to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(slot).to(dev),
            torch.from_numpy(seeds[gid]).to(dev),
            torch.from_numpy(off).to(dev), B, int(slot.max()) + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 31, 300])
@pytest.mark.parametrize("q", [12, 5000])
def test_cuda_segment_bootstrap_repeats_and_replays(B, q):
    """On the card: one launch a call, equal to the plain version bit for
    bit over contiguous, sparse, repeated-slot, empty and masked-out lanes
    (q = 5000 plans in a first kernel), at B = 1, 31 and 300; two calls and
    two graph replays equal; the masked-out and empty lanes read zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _mixed_stream(q, B, seed=q + B)
    b0 = ops.boot_counter.launches
    got = _eager_and_replays(lambda: ops.segment_bootstrap_sorted(*args))
    assert ops.boot_counter.launches > b0
    assert torch.equal(got, ref.segment_bootstrap_sorted_ref(*args))
    assert not got[1].any() and not got[4::6].any()
    assert got[0].any()
