"""CUDA-graph replay of the fused tick's finish-and-test phase
(``core/graphs.py`` :class:`FinishGraphs`: the bootstrap finish from the
moment sums, then TEST and the state merge) beside the pre-read phase's, in
the lane pool's tiers and GROUP BY blocks.

A pool replaying both phases runs in lockstep with its eager twin (the same
pool with its graph caches taken away, as the one-shot entry points run):
heterogeneous avg/var/sum/std lanes, warm lanes, refills beside lanes
mid-flight, two tiers of one key, cold and warm GROUP BY blocks, a rebuild
to another lane count sharing the caches, and two ticks a round.  After
every round every ``LaneState`` leaf of every tier and block is bit-equal to
the twin's, and so is every answer.  Each cache captures once a key and
replays every later phase of it.  A splice's in-place write to one tier's
state leaves a second tier of the same key bit-equal to its twin.

The ``cuda`` cases run real graphs on a card (they skip without one); on
the CPU :class:`StandInFinishGraphs` reruns the captured function on its
staged buffers and the pre-read stand-in's held ones.  This file imports
no JAX.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.aqp.query import Query, Request
from repro_torch.core import keys
from repro_torch.core import fused
from repro_torch.core.fused import LaneState, init_lane_state
from repro_torch.core.graphs import FinishGraphs, PreReadGraphs
from repro_torch.serve import AQPSession, Planner, Route
from repro_torch.serve.lane_pool import LanePool, _splice
from test_torch_fused_graphs import (GROUPED, M, POOL_KW, SOLO,
                                     StandInFinishGraphs, StandInGraphs,
                                     _data, _lockstep, _phases,
                                     _same_answers, _same_rounds, _submit)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors: one intra-op thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CARD = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _caches(device):
    pre = PreReadGraphs() if device == "cuda" else StandInGraphs()
    return pre, pre.finish


def _pair(data, pre, **kw):
    """A pool replaying both phases from ``pre`` and its ``finish``, and
    its eager twin."""
    pool = LanePool(data, **POOL_KW, **kw, pre_read_graphs=pre)
    pool.pre_read_graphs = pre          # a CPU pool makes none itself
    twin = LanePool(data, **POOL_KW, **kw)
    twin.pre_read_graphs = None
    return pool, twin


def _counts(g):
    return g.captures, g.replays, g.eager


@pytest.mark.parametrize("device", CARD)
def test_both_phases_replayed_bit_equal_to_eager_every_round(device):
    data = _data(device)
    pre, fin = _caches(device)
    # Two tiers of two lanes (one key) and GROUP BY blocks (another key).
    pool, twin = _pair(data, pre, lanes=4, tiers=2)
    got, rounds = _lockstep(pool, twin, SOLO, GROUPED, seed=21)
    assert {r.func for r in got} >= {"avg", "var", "sum", "std"}
    assert any(r.warm for r in got) and any(not r.warm for r in got)
    assert pool.migrations == 0 and rounds > 5
    n = _phases(pool)
    assert _counts(fin) == (2, n - 2, 2) == _counts(pre)
    # A rebuild to another lane count shares both caches: one new tier key,
    # the blocks' key replays the captures of the first pool.
    pool2, twin2 = _pair(data, pre, lanes=6, tiers=2)
    _lockstep(pool2, twin2, SOLO[:4], GROUPED[:1], seed=22)
    n += _phases(pool2)
    assert _counts(fin) == (3, n - 3, 3) == _counts(pre)


@pytest.mark.parametrize("device", CARD)
def test_both_phases_two_ticks_a_round(device):
    """``ticks_per_sync = 2``: two replays of each key back to back a
    tier, the finish's outputs cloned out before the next."""
    data = _data(device)
    pre, fin = _caches(device)
    pool, twin = _pair(data, pre, lanes=2, tiers=1, ticks_per_sync=2)
    _lockstep(pool, twin, SOLO[:4], GROUPED[1:], seed=23)
    assert _counts(fin) == (2, _phases(pool) - 2, 2) == _counts(pre)


@pytest.mark.parametrize("device", CARD)
def test_splice_into_one_tier_leaves_its_key_twin_bit_equal(device):
    """Both tiers' states come from replays of one finish graph; a splice
    writes tier 0's leaves in place (as a refill does) and tier 1 stays
    bit-equal to the eager twin's, then and to the end."""
    data = _data(device)
    pre, fin = _caches(device)
    pool, twin = _pair(data, pre, lanes=4, tiers=2)
    ks = keys.split(keys.prng_key(24), 4)
    cold = [sp for sp in SOLO if not sp.get("warm")]
    for spec, k in zip(cold, ks):
        _submit((pool, twin), spec, k)
    for _ in range(3):
        pool.tick()
        twin.tick()
        _same_rounds(pool, twin)
    assert all(t.busy for t in pool._tiers) and fin.replays >= 2
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


@pytest.mark.parametrize("device", CARD)
def test_session_counts_the_finish_phase(device):
    """``AQPSession.stats()`` has the finish cache's counters beside the
    pre-read ones, kept across a rebuild; on the CPU they read 0."""
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
    assert len(sess.drain()) == 4 and sess.pool_rebuilds == 1
    st = sess.stats()
    fin = (st["finish_captures"], st["finish_replays"], st["eager_finish"])
    if device == "cpu":
        assert first.pre_read_graphs is None is sess._pool.pre_read_graphs
        assert fin == (0, 0, 0)
        return
    assert first.pre_read_graphs.finish is sess._pool.pre_read_graphs.finish
    assert fin == (st["graph_captures"], st["graph_replays"],
                   st["eager_pre_read"])
    assert fin == (3, st["fused_dispatches"] - 3, 3)


@pytest.mark.parametrize("device", CARD)
def test_sharded_pool_counts_its_finish_phases_eager(device):
    data = _data(device)
    pre, fin = _caches(device)
    pool = LanePool(data, lanes=2, data_shards=2, mesh=False, **POOL_KW,
                    pre_read_graphs=pre)
    pool.pre_read_graphs = pre
    ks = keys.split(keys.prng_key(25), 3)
    for spec, k in zip(SOLO[:3], ks):
        _submit((pool,), spec, k)
    assert len(pool.drain()) == 3
    assert fin.captures == fin.replays == 0
    assert fin.eager == pre.eager == _phases(pool) > 0


def test_cpu_pool_takes_no_finish_graph_path():
    pool = LanePool(_data("cpu"), lanes=2, **POOL_KW)
    assert pool.pre_read_graphs is None


@pytest.mark.parametrize("cache", [PreReadGraphs, StandInGraphs])
def test_pre_read_cache_owns_its_finish_cache(cache):
    """The finish cache reads its own pre-read cache's buffers: each
    pre-read cache makes its own, of its kind, on its memory pool."""
    a, b = cache(), cache()
    kind = FinishGraphs if cache is PreReadGraphs else StandInFinishGraphs
    assert type(a.finish) is kind and a.finish._pool is a._pool
    assert b.finish is not a.finish and b.finish._pool is not a._pool


@pytest.mark.parametrize("cache", [PreReadGraphs, StandInGraphs])
def test_a_dropped_cache_is_freed_without_the_cycle_collector(cache):
    """The two caches form no reference cycle, so a pool's graphs die with
    their last reference, never inside the cyclic collector, which may run
    during another capture."""
    was = gc.isenabled()
    gc.disable()
    try:
        c = cache()
        gone = weakref.ref(c), weakref.ref(c.finish)
        del c
        assert [r() for r in gone] == [None, None]
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
