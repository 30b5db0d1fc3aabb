"""CUDA-graph replay of the fused tick's pre-read and finish-and-test phases
(``core/graphs.py`` :class:`TickGraphs`) in the lane pool's tiers and GROUP BY
blocks.

A pool replaying both phases runs in lockstep with its eager twin (the same
pool with its graph cache taken away, so every tick runs the whole step
eagerly, as the one-shot entry points do): heterogeneous avg/var/sum/std
lanes, warm lanes, refills beside lanes mid-flight, two tiers of one key,
cold and warm GROUP BY blocks, a rebuild to another lane count sharing the
cache, and two ticks a round.  After every round every ``LaneState`` leaf of
every tier and block is bit-equal to the twin's, and so is every answer.
The cache captures each phase once a key and replays every later phase of
it.  A splice's in-place write to one tier's state leaves a second tier of
the same key bit-equal to its twin.

The ``cuda`` cases run real graphs on a card (they skip without one).  On the
CPU the same checks run with :class:`StandInGraphs`, whose "graph" reruns
the captured function on its static inputs and the buffers it reads in
place: a leaf left unstaged, a key that misses a shape, or an output carried
into the state uncloned would break them there too.  A CPU pool itself
takes no graph path; a sharded step runs both phases eagerly and counts them
so.  This file imports no JAX.
"""
import gc
import types
import weakref

import numpy as np
import pytest
import torch

from repro_torch.aqp.query import Query, Request
from repro_torch.core import fused, graphs, keys, sampling
from repro_torch.core.fused import (FINISH, PRE_READ, LaneState, fused_step,
                                    init_lane_state)
from repro_torch.core.graphs import TickGraphs
from repro_torch.data import make_grouped
from repro_torch.serve import AQPSession, Planner, Route
from repro_torch.serve.lane_pool import LanePool, _splice

POOL_KW = dict(B=64, n_min=200, n_max=400, l=5, max_iters=12,
               n_cap=1 << 12, ext_cap=1 << 10, seed=3)
M = 3
CARD = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]
PHASES = (PRE_READ, FINISH)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return make_grouped(["normal", "exp", "normal"], 20_000, seed=4,
                        biases=[5.0, 3.0, 8.0], device=device)


class StandInGraphs(TickGraphs):
    """A graph cache for the CPU, where no CUDA graph exists: its "graph"
    reruns the captured function on the static input buffers and the
    buffers it reads in place and writes the captured outputs in place, so
    the cache's keys, its staging of every leaf, the in-place reads and the
    reuse of one set of outputs by every replay are exercised as on a
    card."""

    def _capture(self, fn, inputs, in_place):
        static = tuple(x.clone() for x in inputs)
        out = fn(*static, *in_place)

        def replay():
            for dst, src in zip(out, fn(*static, *in_place)):
                if dst is not None:
                    dst.copy_(src)
        return graphs._Graph(types.SimpleNamespace(replay=replay), static,
                             out)


def _cache(device):
    return TickGraphs() if device == "cuda" else StandInGraphs()


def _pair(data, cache, **kw):
    """A pool replaying from ``cache`` and its eager twin."""
    pool = LanePool(data, **POOL_KW, **kw, graphs=cache)
    pool.graphs = cache                 # a CPU pool makes none itself
    twin = LanePool(data, **POOL_KW, **kw)
    twin.graphs = None
    return pool, twin


def _counts(cache, phase):
    return cache.captures[phase], cache.replays[phase], cache.eager[phase]


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a.cpu(), b.cpu()), what


def _same_states(a: LaneState, b: LaneState, what):
    for f in LaneState._fields:
        _same(getattr(a, f), getattr(b, f), f"{what} {f}")


def _same_rounds(pool, twin):
    """Every leaf of every tier and block state bit-equal to the twin's."""
    for i, (t, u) in enumerate(zip(pool._tiers, twin._tiers)):
        _same_states(t.state, u.state, f"tier {i}")
    assert sorted(pool._blocks) == sorted(twin._blocks)
    for qid, blk in pool._blocks.items():
        _same_states(blk.state, twin._blocks[qid].state, f"block {qid}")


def _same_answers(got, want):
    assert [r.qid for r in got] == [r.qid for r in want]
    for a, b in zip(got, want):
        assert np.asarray(a.theta).tobytes() == np.asarray(b.theta).tobytes()
        assert np.asarray(a.error).tobytes() == np.asarray(b.error).tobytes()
        assert np.array_equal(a.n, b.n)
        assert np.array_equal(a.iterations, b.iterations)
        assert a.rows_sampled == b.rows_sampled


WARM_N0 = np.asarray([600, 700, 650], np.int32)
WARM_BETA = np.asarray([1.0, 0.45, 0.5, 0.55], np.float32)
SOLO = [dict(func="avg", epsilon=0.04), dict(func="var", epsilon=0.3),
        dict(func="sum", epsilon=900.0, warm=True),
        dict(func="std", epsilon=0.05), dict(func="avg", epsilon=0.03,
                                             warm=True),
        dict(func="var", epsilon=0.25), dict(func="avg", epsilon=0.05)]
GROUPED = [dict(func="avg", epsilon=0.06),
           dict(func="var", epsilon=0.4, warm=True)]


def _submit(pools, spec, key, grouped=False):
    q = Query(func=spec["func"], epsilon=spec["epsilon"],
              group_by=grouped or None)
    warm = {}
    if spec.get("warm"):
        warm = (dict(warm_n0=WARM_N0, warm_beta=np.tile(WARM_BETA[:2], (M, 1)))
                if grouped else dict(warm_n0=WARM_N0, warm_beta=WARM_BETA))
    for p in pools:
        (p.submit_group if grouped else p.submit)(q, key=key, **warm)


def _lockstep(pool, twin, solo, grouped, seed):
    """Serve ``solo`` and ``grouped`` through both pools in lockstep: half
    up front, the rest after three rounds (refills beside lanes
    mid-flight), comparing after every round.  Returns the pool's answers
    and the rounds run."""
    ks = keys.split(keys.prng_key(seed), len(solo) + len(grouped))
    half = len(solo) // 2
    for spec, k in zip(solo[:half], ks):
        _submit((pool, twin), spec, k)
    _submit((pool, twin), grouped[0], ks[len(solo)], grouped=True)
    rounds = 0
    while pool.busy_lanes or pool.queue_depth or pool.busy_blocks:
        assert rounds < 500
        pool.tick()
        twin.tick()
        rounds += 1
        _same_rounds(pool, twin)
        if rounds == 3:
            for spec, k in zip(solo[half:], ks[half:]):
                _submit((pool, twin), spec, k)
            for spec, k in zip(grouped[1:], ks[len(solo) + 1:]):
                _submit((pool, twin), spec, k, grouped=True)
    assert not (twin.busy_lanes or twin.queue_depth or twin.busy_blocks)
    got, want = pool.drain(), twin.drain()
    _same_answers(got, want)
    assert len(got) == len(solo) + len(grouped)
    return got, rounds


def _phases(pool):
    """Phases of each kind a pool ran: one a tick of a busy tier or a
    block."""
    return pool.dispatches * pool.ticks_per_sync


@pytest.mark.parametrize("seeds", [(11, 12), (21, 22)])
@pytest.mark.parametrize("device", CARD)
def test_replayed_pool_is_bit_equal_to_eager_every_round(device, seeds):
    data = _data(device)
    cache = _cache(device)
    # Two tiers of two lanes (one key) and GROUP BY blocks (another key).
    pool, twin = _pair(data, cache, lanes=4, tiers=2)
    got, rounds = _lockstep(pool, twin, SOLO, GROUPED, seed=seeds[0])
    assert {r.func for r in got} >= {"avg", "var", "sum", "std"}
    assert any(r.warm for r in got) and any(not r.warm for r in got)
    assert pool.migrations == 0 and rounds > 5
    n = _phases(pool)
    for phase in PHASES:
        assert _counts(cache, phase) == (2, n - 2, 2)
    # A rebuild to another lane count shares the cache: one new tier key,
    # the blocks' key replays the captures of the first pool.
    pool2, twin2 = _pair(data, cache, lanes=6, tiers=2)
    _lockstep(pool2, twin2, SOLO[:4], GROUPED[:1], seed=seeds[1])
    n += _phases(pool2)
    for phase in PHASES:
        assert _counts(cache, phase) == (3, n - 3, 3)


@pytest.mark.parametrize("seed", [13, 23])
@pytest.mark.parametrize("device", CARD)
def test_replayed_pool_two_ticks_a_round(device, seed):
    """``ticks_per_sync = 2``: two replays of each key back to back a
    tier, the pre-read outputs consumed and the finish's cloned out before
    the next."""
    data = _data(device)
    cache = _cache(device)
    pool, twin = _pair(data, cache, lanes=2, tiers=1, ticks_per_sync=2)
    _lockstep(pool, twin, SOLO[:4], GROUPED[1:], seed=seed)
    for phase in PHASES:
        assert _counts(cache, phase) == (2, _phases(pool) - 2, 2)


@pytest.mark.parametrize("device", CARD)
def test_splice_into_one_tier_leaves_its_key_twin_bit_equal(device):
    """Both tiers' states come from replays of one finish graph; a splice
    writes tier 0's leaves in place (as a refill does) and tier 1 stays
    bit-equal to the eager twin's, then and to the end."""
    data = _data(device)
    cache = _cache(device)
    pool, twin = _pair(data, cache, lanes=4, tiers=2)
    ks = keys.split(keys.prng_key(24), 4)
    cold = [sp for sp in SOLO if not sp.get("warm")]
    for spec, k in zip(cold, ks):
        _submit((pool, twin), spec, k)
    for _ in range(3):
        pool.tick()
        twin.tick()
        _same_rounds(pool, twin)
    assert all(t.busy for t in pool._tiers) and cache.replays[FINISH] >= 2
    for p in (pool, twin):
        tier = p._tiers[0]
        lane = next(i for i, t in enumerate(tier.occupant) if t is not None)
        tk = tier.occupant[lane]
        # Restart the occupant's query in place: its rows, at tick 0.
        _splice(tier.state, tier.params, [lane], tk.key[None],
                tk.scale_row[None], np.asarray([tk.eps_run]),
                np.asarray([tk.delta]), np.asarray([tk.fid]),
                np.asarray([False]), np.zeros((1, M), np.int32),
                np.zeros((1, M + 1), np.float32), n_min=POOL_KW["n_min"])
        tier.filled_host[lane] = 0
    _same_rounds(pool, twin)
    rounds = 0
    while pool.busy_lanes:
        assert rounds < 500
        pool.tick()
        twin.tick()
        rounds += 1
        _same_rounds(pool, twin)
    assert not twin.busy_lanes
    _same_answers(pool.drain(), twin.drain())


SESSION_COUNTERS = {
    "pre_read": ("graph_captures", "graph_replays", "eager_pre_read"),
    "finish": ("finish_captures", "finish_replays", "eager_finish")}


@pytest.mark.parametrize("phase", sorted(SESSION_COUNTERS))
@pytest.mark.parametrize("device", CARD)
def test_session_counts_survive_a_rebuild(device, phase):
    """``AQPSession.stats()`` carries the session's counters of each phase;
    a rebuilt pool keeps the session's cache.  On the CPU the session's
    pools take no graph path and every counter reads 0."""
    data = _data(device)
    planner = Planner(mode=Route.POOL, pool_lanes=2, pool_ticks_per_sync=1,
                      cooldown=0)
    sess = AQPSession(data, planner=planner, B=64, n_min=200, n_max=400,
                      max_iters=12, n_cap=1 << 12, seed=5,
                      reshuffle_every=1000)
    for f in ("avg", "var"):
        sess.submit(Request(query=Query(func=f, epsilon=0.2)))
    sess.drain()
    first = sess._pool
    planner.pool_lanes = 4              # the next idle round rebuilds
    for f in ("avg", "std", "var"):
        sess.submit(Request(query=Query(func=f, epsilon=0.2)))
    sess.submit(Request(query=Query(func="avg", epsilon=0.3,
                                    group_by=True)))
    res = sess.drain()
    assert len(res) == 4 and all(r.route is Route.POOL for r in res)
    assert sess.pool_rebuilds == 1 and sess._pool.lanes == 4
    st = sess.stats()
    got = tuple(st[k] for k in SESSION_COUNTERS[phase])
    if device == "cpu":
        assert first.graphs is None is sess._pool.graphs
        assert got == (0, 0, 0)
        return
    assert first.graphs is sess._pool.graphs
    # Keys: one tier lane each, two each, one GROUP BY block.
    assert got == (3, st["fused_dispatches"] - 3, 3)


@pytest.mark.parametrize("graphs_given", [True, False])
def test_cpu_pool_takes_no_graph_path(graphs_given):
    data = _data("cpu")
    pool = LanePool(data, lanes=2, **POOL_KW,
                    graphs=TickGraphs() if graphs_given else None)
    assert pool.graphs is None
    pool.submit(Query("avg", epsilon=0.1), key=keys.prng_key(1))
    (r,) = pool.drain()
    assert r.success


@pytest.mark.parametrize("seed", [14, 25])
@pytest.mark.parametrize("device", CARD)
def test_sharded_pool_counts_its_phases_eager(device, seed):
    """A pool over two data segments replays nothing: every tick's
    pre-read and finish-and-test phases run eagerly in the sharded step and
    count as eager, so the share of phases replayed reads 0."""
    data = _data(device)
    cache = _cache(device)
    pool = LanePool(data, lanes=2, data_shards=2, mesh=False, **POOL_KW,
                    graphs=cache)
    pool.graphs = cache                 # a CPU pool makes none itself
    ks = keys.split(keys.prng_key(seed), 3)
    for spec, k in zip(SOLO[:3], ks):
        _submit((pool,), spec, k)
    assert len(pool.drain()) == 3
    n = _phases(pool)
    assert n > 0
    for phase in PHASES:
        assert _counts(cache, phase) == (0, 0, n)


def _sharded_case(S=2, q=2, n_cap=256):
    values = torch.as_tensor(
        np.random.default_rng(0).normal(3.0, 1.0, (1200, 1)),
        dtype=torch.float32)
    offsets = [0, 500, 1200]
    layout = sampling.ShardLayout.build(offsets, n_cap=n_cap, num_shards=S)
    ks = keys.split(keys.prng_key(7), q)
    params = fused.make_sharded_lane_params(
        layout, np.ones((q, 2), np.float32), ks, np.full((q,), 0.05,
                                                         np.float32),
        np.full((q,), 0.05, np.float32), keys.prng_key(8), local_rows=False,
        device="cpu")
    state = init_lane_state(ks, 2, n_cap=n_cap, c_dim=1, p_dim=1, n_min=32,
                            max_iters=6, device="cpu")
    return (layout.pad_values(values), offsets, params,
            fused.make_shard_spec(layout, device="cpu"), state)


def test_sharded_step_counts_its_phases_eager():
    """Given a cache, the sharded step runs both phases eagerly, counts
    each tick in both eager counters, captures nothing and answers as
    without the cache."""
    values, offsets, params, spec, state = _sharded_case()
    kw = dict(est_name="avg", B=32, n_min=32, n_max=64, l=4, max_iters=6,
              n_cap=256, data_shards=2, num_ticks=3, use_kernel=False)
    cache = StandInGraphs()
    got = fused_step(values, offsets, state, params, spec, graphs=cache,
                     **kw)
    _, _, _, _, state2 = _sharded_case()
    want = fused_step(values, offsets, state2, params, spec, **kw)
    _same_states(got, want, "sharded")
    for phase in PHASES:
        assert _counts(cache, phase) == (0, 0, 3)


def _tiny_ticks(cache, block: bool, ticks: int = 3):
    """``ticks`` ticks of a small tier or GROUP BY block through ``cache``
    and the same ticks eagerly; returns both states."""
    data = _data("cpu")
    off = np.asarray(data.offsets)
    kw = dict(est_name="avg", B=32, n_min=64, n_max=128, l=4, max_iters=8,
              n_cap=1 << 10, use_kernel=False)
    if block:
        ks = np.stack([keys.fold_in(keys.prng_key(5), g) for g in range(M)])
        mk = lambda: fused.make_group_lane_params(
            off, np.ones((M,), np.float32), ks, np.full((M,), 0.05,
                                                        np.float32),
            np.full((M,), 0.05, np.float32), keys.prng_key(6),
            n_cap=kw["n_cap"], device="cpu")
        m, step_off = 1, [0, int(off[-1])]
        kw.update(seg_cap=fused.grouped_seg_cap(off, kw["n_cap"]))
    else:
        ks = keys.split(keys.prng_key(5), 2)
        mk = lambda: fused.make_lane_params(
            off, np.ones((2, M), np.float32), ks, np.full((2,), 0.05,
                                                          np.float32),
            np.full((2,), 0.05, np.float32), keys.prng_key(6),
            n_cap=kw["n_cap"], device="cpu")
        m, step_off = M, off
    states = []
    for g in (cache, None):
        params = mk()
        s = init_lane_state(ks, m, n_cap=kw["n_cap"], c_dim=1, p_dim=1,
                            n_min=64, max_iters=8, device="cpu")
        for _ in range(ticks):
            s = fused_step(data.values, step_off, s, params, graphs=g, **kw)
        states.append(s)
    return states


@pytest.mark.parametrize("block", [False, True])
def test_one_cache_captures_both_phases_of_a_key_once(block):
    """One cache holds both phases of a tier's or a block's key: the first
    tick runs each eagerly and captures it, every later tick replays both,
    the finish reading the pre-read graph's buffers in place, bit-equal to
    the eager ticks."""
    cache = StandInGraphs()
    got, want = _tiny_ticks(cache, block)
    _same_states(got, want, "block" if block else "tier")
    for phase in PHASES:
        assert _counts(cache, phase) == (1, 2, 1)
    (tick,) = cache._ticks.values()
    assert sorted(ph.replay for ph, _ in tick.graphs) == [
        "lane_pool.step.finish_replay", "lane_pool.step.replay"]


@pytest.mark.parametrize("cache", [TickGraphs, StandInGraphs])
def test_a_dropped_cache_is_freed_without_the_cycle_collector(cache):
    """Nothing a cache holds refers back to it, so a pool's graphs die
    with their last reference, never inside the cyclic collector, which may
    run during another capture."""
    was = gc.isenabled()
    gc.disable()
    try:
        c = cache()
        if cache is StandInGraphs:
            _tiny_ticks(c, block=False, ticks=2)    # records of both phases
        gone = weakref.ref(c)
        del c
        assert gone() is None
    finally:
        if was:
            gc.enable()


def _lane_state(q):
    return init_lane_state(keys.split(keys.prng_key(0), q), M, n_cap=8,
                           c_dim=2, p_dim=M + 1, n_min=1, max_iters=4,
                           device="cpu")


def test_finish_leaves_unpack_as_views_of_one_buffer():
    """The packed finish outputs come back as the state's leaves, each a
    view of the one buffer with its leaf's dtype and shape."""
    s = _lane_state(3)
    gen = torch.Generator().manual_seed(0)
    new = {}
    for f in fused._FINISH_OUT:
        like = getattr(s, f)
        bits = torch.randint(0, 2 if like.dtype == torch.bool else 1 << 20,
                             like.shape, generator=gen)
        new[f] = bits.to(like.dtype)
    parts = [new[f].reshape(-1).view(torch.uint8) for f in fused._FINISH_OUT]
    flat = torch.cat(parts + [parts[-1].new_zeros(
        -sum(x.numel() for x in parts) % 4)])
    got = fused._unpack_finish(flat, s)
    for f in LaneState._fields:
        want = new.get(f, getattr(s, f))
        assert torch.equal(getattr(got, f), want), f
    ptr = flat.untyped_storage().data_ptr()
    assert all(getattr(got, f).untyped_storage().data_ptr() == ptr
               for f in fused._FINISH_OUT)


def test_finish_leaf_off_its_boundary_raises():
    """A layout that would start a 4-byte leaf off its boundary raises
    instead of reading a shifted view."""
    s = _lane_state(3)
    s = s._replace(k=torch.zeros(3, dtype=torch.bool))     # 3 bytes first
    flat = torch.zeros(4096, dtype=torch.uint8)
    with pytest.raises(ValueError, match="boundary"):
        fused._unpack_finish(flat, s)
