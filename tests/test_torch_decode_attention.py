"""The port's decode-attention op against the JAX reference: its plain
version against the reference's Pallas kernel (interpret mode, as the
reference's own tests run it) on the four shapes of the reference's kernel
test, on h2o-danube's head dimension (120) and on 12 and 16 query heads a
KV head (Command R+'s decode shape among them) in f32 and bf16, a poisoned
tail, per-row lengths against the reference decode path's ``_sdpa`` under
the decode mask, with and without a sliding window, the partition of each
row's range, and, on a card, the CUDA kernel against its plain version.

Tolerances: f32 at rtol 1e-5, atol 1e-6 (both sides accumulate in f32 in
different orders); bf16 within one bf16 ulp, since both sides compute in f32
and round once to bf16.  On the card the bf16 check adds the f32 atol: an
output that cancels to ~1e-6 carries f32 rounding of ~1e-8 from either
summation order, more than a bf16 ulp of so small a value.
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro_torch.kernels.decode_attention import ops, ref

SHAPES = [                      # tests/test_kernels.py's decode shapes
    (1, 8, 2, 128, 1024, 512),
    (2, 4, 4, 64, 600, 256),    # kv_len not a tile multiple
    (1, 16, 8, 128, 512, 128),
    (2, 8, 1, 128, 768, 256),   # MQA
    (2, 8, 2, 120, 300, 128),   # h2o-danube's head dimension
    (8, 96, 8, 128, 64, 64),    # Command R+'s decode: 12 query heads a KV head
    (2, 32, 2, 64, 200, 128),   # 16 query heads a KV head, the kernel's most
]
# The cross-attention decoders' decode shapes on the card, (B, Hq, Hkv, d,
# S, lengths): SeamlessM4T's self-attention (16 over 16 heads of 64, G = 1)
# and its cross-attention over 4 096 frames, Llama-3.2-Vision's
# self-attention (64 over 8 heads of 128) and its cross-attention over 1 600
# image tokens; a cross-attention reads the whole memory.
_rng = np.random.default_rng(21)
CROSS_DECODER_SHAPES = [
    (8, 16, 16, 64, 128, _rng.integers(65, 97, 8)),
    (8, 16, 16, 64, 4096, np.full(8, 4096)),
    (8, 64, 8, 128, 128, _rng.integers(17, 97, 8)),
    (8, 64, 8, 128, 1600, np.full(8, 1600)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.decode_attention import ops as jops
    from repro.models import attention as jattn
    return dict(jnp=jnp, ops=jops, attn=jattn)


def _case(B, Hq, Hkv, d, S, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, Hq, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((B, S, Hkv, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, d)).astype(np.float32)
    return q, k, v


def assert_within_bf16_ulp(got: torch.Tensor, want_f32: torch.Tensor,
                           atol: float = 0.0):
    """|got - bf16(want)| <= atol + one bf16 ulp of the larger magnitude."""
    want = want_f32.to(torch.bfloat16).float()
    g = got.float()
    mag = torch.maximum(g.abs(), want.abs())
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag).exponent - 8)
    bad = (g - want).abs() > ulp + atol
    assert not bad.any(), (g[bad][:5], want[bad][:5])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,d,S,tk", SHAPES)
def test_plain_vs_reference_kernel(jx, B, Hq, Hkv, d, S, tk, dtype):
    jnp = jx["jnp"]
    q, k, v = _case(B, Hq, Hkv, d, S, seed=B * 1000 + S)
    jdt = getattr(jnp, dtype)
    got_j = jx["ops"].decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        kv_len=S, tk=tk, interpret=True)
    tdt = getattr(torch, dtype)
    tq, tk_, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = ops.decode_attention(tq, tk_, tv, S)
    assert got.dtype == tdt and got.shape == (B, Hq, d)
    want = np.asarray(got_j.astype(jnp.float32))
    if dtype == "float32":
        assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        # The reference kernel's f32 result, rounded once to bf16.
        assert_within_bf16_ulp(got, torch.from_numpy(want.copy()))
        f32 = ref.decode_attention_ref(tq.float(), tk_.float(), tv.float(), S)
        assert_within_bf16_ulp(got, f32)


def test_poisoned_tail_adds_nothing():
    """Positions at and past kv_len never contribute, whatever they hold."""
    B, Hq, Hkv, d, S, L = 1, 4, 2, 64, 512, 300
    q, k, v = (torch.from_numpy(a) for a in _case(B, Hq, Hkv, d, S, seed=5))
    clean = ops.decode_attention(q, k[:, :L].clone(), v[:, :L].clone(), L)
    k[:, L:] = 100.0
    v[:, L:] = 1e9
    v[:, L + 7] = float("nan")
    got = ops.decode_attention(q, k, v, L)
    assert torch.isfinite(got).all()
    assert float(got.abs().max()) < 100.0
    assert_allclose(got.numpy(), clean.numpy(), rtol=1e-5, atol=1e-6)


def test_per_row_lengths_match_reference_decode_mask(jx):
    """Each row attends over its own first kv_len[b] positions: the
    reference decode path's ``_sdpa`` with ``kj < kv_len[b]``; a row of
    length 0 reads zeros (nothing to attend)."""
    jnp = jx["jnp"]
    B, Hq, Hkv, d, S = 5, 12, 2, 128, 96
    q, k, v = _case(B, Hq, Hkv, d, S, seed=17)
    lens = np.array([1, 37, 96, 64, 5], np.int32)
    mask = np.arange(S)[None, None, :] < lens[:, None, None]     # (B, 1, S)
    want = np.asarray(jx["attn"]._sdpa(
        jnp.asarray(q[:, None]), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(mask), None))[:, 0]
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lens))
    assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    zero = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v),
                                torch.tensor([0, 3, 0, 1, 2]))
    assert not zero[0].any() and not zero[2].any()


def test_cpu_never_launches_and_kernel_demand_raises():
    q, k, v = (torch.from_numpy(a) for a in _case(2, 4, 2, 32, 40, seed=3))
    n = ops.counter.launches
    ops.decode_attention(q, k, v, 10)
    assert ops.counter.launches == n
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q, k, v, 10, use_kernel=True)
    with pytest.raises(ValueError):
        ops.decode_attention(q, k[:, :, :1], v, 10)        # shapes differ


SERVE_LENS = np.random.default_rng(13).integers(33, 1057, 8)   # the serve's
EDGE_LENS = [0, 1, 63, 64, 65, 2048, 2049, 700]                 # S_max = 2048
# 264 (row, KV head) pairs fill a 132-SM grid one block each, and S = 2112
# needs chunks past the kernel's 32 candidates: its bisect path.
GRID_BOUND = (264, 4, 1, 32, 2112)
GRID_LENS = np.random.default_rng(7).integers(0, 2113, 264)


def _coverage(lens, Hkv, S, n_sm, tile, window=None):
    n_blocks, chunk, blocks = ops.partition(lens, len(lens), Hkv, S, n_sm,
                                            tile, window)
    seen = {}
    for b, h, lo, hi in blocks:
        seen.setdefault((b, h), []).append((lo, hi))
    return n_blocks, chunk, blocks, seen


def test_windowed_rows_match_reference_decode_mask(jx):
    """Under a sliding window of W, row b attends over [kv_len[b] - W,
    kv_len[b]): the reference decode path's ``_sdpa`` with ``kj <= length``
    and ``kj > length - W`` at ``length = kv_len - 1``, at lengths below,
    at and past the window (W - 1, W, W + 1), for d = 120 and 128; rows
    before the window, poisoned, add nothing."""
    jnp = jx["jnp"]
    W, S = 48, 128
    lens = np.array([W - 1, W, W + 1, 1, 2 * W + 5, S, S + 3], np.int32)
    for d in (120, 128):
        q, k, v = _case(len(lens), 8, 2, d, S, seed=d)
        length = lens[:, None] - 1
        kj = np.arange(S)[None, :]
        mask = ((kj <= length) & (kj > length - W))[:, None, :]
        want = np.asarray(jx["attn"]._sdpa(
            jnp.asarray(q[:, None]), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask), None))[:, 0]
        lo = np.maximum(lens - W, 0)
        for b, lo_b in enumerate(lo):
            k[b, :lo_b] = 100.0
            v[b, :lo_b] = float("nan")
        got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), torch.from_numpy(lens),
                                   window=W)
        assert torch.isfinite(got).all()
        assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
        got_int = ops.decode_attention(
            torch.from_numpy(q[:3]), torch.from_numpy(k[:3]),
            torch.from_numpy(v[:3]), W + 1, window=W)
        assert_allclose(got_int[2].numpy(), want[2], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="window"):
        ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), 4, window=0)


def test_window_bounds_are_the_kernel_arithmetic():
    """``ref.bounds`` and ``ops.row_range`` agree: hi = min(len, S), lo =
    min(max(len - W, 0), hi); a row whose window passed the cache is
    empty."""
    lens = [0, 1, 15, 16, 17, 40, 55, 70, 90]
    lo, hi = ref.bounds(torch.tensor(lens), len(lens), 40, 16, "cpu")
    assert list(zip(lo.tolist(), hi.tolist())) == [
        ops.row_range(L, 40, 16) for L in lens]
    assert ops.row_range(17, 40, 16) == (1, 17)
    assert ops.row_range(70, 40, 16) == (40, 40)
    assert ops.row_range(17, 40, None) == (0, 17)


@pytest.mark.parametrize("window", [None, 64, 700])
@pytest.mark.parametrize("tile", [64, 32])
@pytest.mark.parametrize("Hkv,S,n_sm,lens", [
    (2, 2048, 132, SERVE_LENS),
    (2, 2048, 132, EDGE_LENS),
    (2, 2048, 132, [2048] * 8),
    (2, 2048, 132, [64] * 8),
    (2, 2048, 132, [0] * 8),
    (1, 600, 132, [600, 599]),
    (8, 512, 4, [512]),                 # fewer SMs than pairs x tiles
    (4, 4096, 132, [5000, 17, 0, 4096, 1]),
    (2, 96, 132, [1, 37, 96, 64, 5]),
    (1, 2112, 132, GRID_LENS),
])
def test_partition_covers_every_position_once(Hkv, S, n_sm, lens, tile,
                                              window):
    """Every position of every (row, KV head)'s range -- [0, len), or
    [len - window, len) under a window -- lies in exactly one split, in
    order; no split of a non-empty pair is empty, a pair with an empty range
    has one block (it writes zeros); the splits fit the grid."""
    n_blocks, chunk, blocks, seen = _coverage(lens, Hkv, S, n_sm, tile,
                                              window)
    assert chunk % tile == 0 and len(blocks) <= n_blocks
    assert sorted(seen) == [(b, h) for b in range(len(lens))
                            for h in range(Hkv)]
    assert blocks == sorted(blocks)     # rows, then heads, then splits
    for (b, h), spans in seen.items():
        L = min(max(int(lens[b]), 0), S)
        first = 0 if window is None else min(max(int(lens[b]) - window, 0), L)
        if first == L:
            assert spans == [(L, L)]
            continue
        assert all(first <= lo < hi <= lo + chunk for lo, hi in spans)
        covered = [t for lo, hi in spans for t in range(lo, hi)]
        assert covered == list(range(first, L))


@pytest.mark.parametrize("B,Hkv,S,n_sm", [(8, 2, 2048, 132), (2, 4, 600, 132),
                                          (64, 8, 128, 132), (1, 1, 64, 8)])
def test_partition_grid_depends_only_on_shape(B, Hkv, S, n_sm):
    """The grid (and so a CUDA graph's launch) depends on (B, Hkv, S_max,
    n_sm) only; the lengths move the chunk and the busy blocks."""
    rng = np.random.default_rng(B * S)
    grids = {ops.partition(lens, B, Hkv, S, n_sm)[0]
             for lens in ([0] * B, [S] * B, rng.integers(0, S + 1, B),
                          rng.integers(0, 2 * S, B))}
    assert grids == {ops.grid_blocks(B, Hkv, S, n_sm)}
    assert B * Hkv <= grids.pop() <= max(B * Hkv, ops.BLOCKS_PER_SM * n_sm)


@pytest.mark.parametrize("lens", [SERVE_LENS, [2048] * 8, [64] * 8,
                                  EDGE_LENS])
def test_partition_balances_the_serve(lens):
    """At the serve's shape no block holds more than one tile beyond the
    even share of the valid positions rounded up to whole tiles, and the
    busy blocks cover the card's SMs as far as whole tiles allow."""
    Hkv, S, n_sm, tile = 2, 2048, 132, 64
    n_blocks, chunk, blocks, _ = _coverage(lens, Hkv, S, n_sm, tile)
    work = Hkv * sum(min(int(L), S) for L in lens)
    even = -(-work // n_blocks)
    assert chunk <= -(-even // tile) * tile + tile
    assert max(hi - lo for _, _, lo, hi in blocks) <= chunk
    assert len(blocks) >= min(n_sm, work // chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """On the card: the kernel against its plain version at the serve's
    shape with per-row lengths and a poisoned tail, at the edge lengths, at
    a grid-bound shape, at Command R+'s decode shape (12 query heads a KV
    head) with its serve's lengths, at the cross-attention decoders'
    shapes, and at the shapes above; one counted
    launch per call; repeated
    calls and CUDA-graph replays equal bit for bit; int32, int64 and int
    lengths alike."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    serve = (8, 12, 2, 128, 2048)
    cases = [(*serve, rng.integers(1, 1057, 8)), (*serve, np.array(EDGE_LENS)),
             (*GRID_BOUND, GRID_LENS),
             (8, 96, 8, 128, 64, np.arange(17, 33, 2))]   # Command R+'s serve
    cases += CROSS_DECODER_SHAPES
    cases += [(B, Hq, Hkv, d, S, np.full(B, S)) for B, Hq, Hkv, d, S, _
              in SHAPES]
    for B, Hq, Hkv, d, S, lens in cases:
        q, k, v = (torch.from_numpy(a).to(dev, tdt)
                   for a in _case(B, Hq, Hkv, d, S, seed=S))
        kv_len = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        for b, L in enumerate(lens):
            k[b, L:] = 100.0
            v[b, L:] = float("nan")
        n = ops.counter.launches
        got = ops.decode_attention(q, k, v, kv_len)
        assert ops.counter.launches == n + 1
        want = ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                        kv_len)
        torch.cuda.synchronize()
        if dtype == "float32":
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            assert_within_bf16_ulp(got, want, atol=1e-6)
        assert torch.equal(ops.decode_attention(q, k, v, kv_len), got)
        assert torch.equal(ops.decode_attention(q, k, v, kv_len.long()), got)
        if len(set(np.minimum(lens, S).tolist())) == 1:
            assert torch.equal(ops.decode_attention(q, k, v, int(lens[0])),
                               got)
    # A CUDA graph of one call replays the eager result, and a second replay
    # the first (the arrival counters were left zero).
    B, Hq, Hkv, d, S = serve
    q, k, v = (torch.from_numpy(a).to(dev, tdt)
               for a in _case(B, Hq, Hkv, d, S, seed=1))
    kv_len = torch.as_tensor(rng.integers(1, S + 1, B), device=dev)
    eager = ops.decode_attention(q, k, v, kv_len)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.decode_attention(q, k, v, kv_len)
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first, eager) and torch.equal(out, first)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_windowed_kernel_matches_plain_version(dtype):
    """On the card: the windowed kernel against its plain version at
    h2o-danube's decode shape (8 rows, 32 query over 8 KV heads, d = 120,
    window 4096, S_max = 8192) and at d = 128, lengths below, at and past
    the window (W - 1, W, W + 1 included), positions outside each range
    poisoned; one counted launch a call; int and tensor lengths agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    W, S = 4096, 8192
    lens = np.array([W - 1, W, W + 1, 1, 5000, 8192, 6000, 4200])
    for d in (120, 128):
        q, k, v = (torch.from_numpy(a).to(dev, tdt)
                   for a in _case(8, 32, 8, d, S, seed=d))
        for b, L in enumerate(lens):
            lo = max(int(L) - W, 0)
            k[b, :lo] = 100.0
            v[b, :lo] = float("nan")
            k[b, L:] = 100.0
            v[b, L:] = float("nan")
        kv_len = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        n = ops.counter.launches
        got = ops.decode_attention(q, k, v, kv_len, window=W)
        assert ops.counter.launches == n + 1
        want = ref.decode_attention_ref(q.float(), k.float(), v.float(),
                                        kv_len, W)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        if dtype == "float32":
            assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            assert_within_bf16_ulp(got, want, atol=1e-6)
        assert torch.equal(ops.decode_attention(q, k, v, kv_len, window=W),
                           got)
        qc, kc, vc = (torch.from_numpy(a).to(dev, tdt)
                      for a in _case(8, 32, 8, d, S, seed=d + 1))
        same = torch.full((8,), W + 1, dtype=torch.int64, device=dev)
        one = ops.decode_attention(qc, kc, vc, W + 1, window=W)
        assert torch.isfinite(one).all()
        assert torch.equal(one, ops.decode_attention(qc, kc, vc, same,
                                                     window=W))
