"""CUDA-graph replay of the fused tick's pre-read phase
(``core/graphs.py``) in the lane pool's tiers and GROUP BY blocks.

A pool that replays the phase runs in lockstep with its eager twin (the same
pool with its graph cache taken away, so every tick runs the whole step
eagerly, as the one-shot entry points do), over cold and warm lanes, refills
while other lanes are mid-flight, two tiers of one key, cold and warm GROUP BY
blocks, and a rebuild to another lane count sharing the cache: after every
round every ``LaneState`` leaf of every tier and block is bit-equal to the
twin's, and so is every answer.  The cache captures once a key and replays
every later pre-read phase.

The ``cuda`` cases run real graphs on a card (they skip without one).  On the
CPU the same checks run with :class:`StandInGraphs`, whose "graph" reruns
the captured function on its static inputs: a leaf left unstaged, a key
that misses a shape, or an output carried into the state would break them
there too.  A CPU pool itself takes no graph path; a sharded pool's step
runs the phase eagerly and counts it so.  This file imports no JAX.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.aqp.query import Query, Request
from repro_torch.core import keys
from repro_torch.core.fused import LaneState, fused_step, init_lane_state
from repro_torch.core import graphs
from repro_torch.core.graphs import FinishGraphs, PreReadGraphs
from repro_torch.data import make_grouped
from repro_torch.serve import AQPSession, Planner, Route
from repro_torch.serve.lane_pool import LanePool

POOL_KW = dict(B=64, n_min=200, n_max=400, l=5, max_iters=12,
               n_cap=1 << 12, ext_cap=1 << 10, seed=3)
M = 3


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


class _StandIn:
    """A graph cache for the CPU, where no CUDA graph exists: its "graph"
    reruns the captured function on the static input buffers and the held
    tensors and writes the captured outputs in place, so the cache's keys,
    its staging of every leaf, the held buffers and the reuse of one set of
    outputs by every replay are exercised as on a card."""

    def _capture(self, fn, inputs, held):
        static = tuple(x.clone() for x in inputs)
        out = fn(*static, *held)

        def replay():
            for dst, src in zip(out, fn(*static, *held)):
                if dst is not None:
                    dst.copy_(src)
        return graphs._Graph(types.SimpleNamespace(replay=replay), static,
                             out)


class StandInFinishGraphs(_StandIn, FinishGraphs):
    """A :class:`FinishGraphs` for the CPU (:class:`_StandIn`), owned by a
    :class:`StandInGraphs`."""


class StandInGraphs(_StandIn, PreReadGraphs):
    """A :class:`PreReadGraphs` for the CPU (:class:`_StandIn`), whose
    ``finish`` cache is a :class:`StandInFinishGraphs`."""

    def __init__(self):
        super().__init__()
        self.finish = StandInFinishGraphs(self._pool)


def _cache(device):
    return PreReadGraphs() if device == "cuda" else StandInGraphs()


def _pair(data, cache, **kw):
    """A pool replaying from ``cache`` and its eager twin."""
    pool = LanePool(data, **POOL_KW, **kw, pre_read_graphs=cache)
    pool.pre_read_graphs = cache        # a CPU pool makes none itself
    twin = LanePool(data, **POOL_KW, **kw)
    twin.pre_read_graphs = None
    return pool, twin


def _same(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(a.cpu(), b.cpu()), what


def _same_rounds(pool, twin):
    """Every leaf of every tier and block state bit-equal to the twin's."""
    for i, (t, u) in enumerate(zip(pool._tiers, twin._tiers)):
        for f in LaneState._fields:
            _same(getattr(t.state, f), getattr(u.state, f), f"tier {i} {f}")
    assert sorted(pool._blocks) == sorted(twin._blocks)
    for qid, blk in pool._blocks.items():
        for f in LaneState._fields:
            _same(getattr(blk.state, f), getattr(twin._blocks[qid].state, f),
                  f"block {qid} {f}")


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
    mid-flight), comparing after every round.  Returns both answer lists
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
    """Pre-read phases a pool ran: one a tick of a busy tier or a block."""
    return pool.dispatches * pool.ticks_per_sync


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_replayed_pool_is_bit_equal_to_eager_every_round(device):
    data = _data(device)
    cache = _cache(device)
    # Two tiers of two lanes (one key) and GROUP BY blocks (another key).
    pool, twin = _pair(data, cache, lanes=4, tiers=2)
    got, rounds = _lockstep(pool, twin, SOLO, GROUPED, seed=11)
    assert any(r.warm for r in got) and any(not r.warm for r in got)
    assert pool.migrations == 0 and rounds > 5
    assert cache.captures == 2 and cache.eager == 2
    assert cache.replays == _phases(pool) - cache.captures
    # A rebuild to another lane count shares the cache: one new tier key,
    # the blocks' key replays the capture of the first pool.
    pool2, twin2 = _pair(data, cache, lanes=6, tiers=2)
    _lockstep(pool2, twin2, SOLO[:4], GROUPED[:1], seed=12)
    assert cache.captures == 3 and cache.eager == 3
    assert cache.replays == _phases(pool) + _phases(pool2) - 3


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_replayed_pool_two_ticks_a_round(device):
    """``ticks_per_sync = 2``: two replays of one key back to back a tier,
    each consumed before the next."""
    data = _data(device)
    cache = _cache(device)
    pool, twin = _pair(data, cache, lanes=2, tiers=1, ticks_per_sync=2)
    _lockstep(pool, twin, SOLO[:4], GROUPED[1:], seed=13)
    assert cache.captures == 2
    assert cache.replays == _phases(pool) - 2


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_session_counts_survive_a_rebuild(device):
    """``AQPSession.stats()`` carries the session's counters; a rebuilt
    pool keeps the session's cache.  On the CPU the session's pools take no
    graph path and every counter reads 0."""
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
    if device == "cpu":
        assert first.pre_read_graphs is None
        assert sess._pool.pre_read_graphs is None
        assert (st["graph_captures"], st["graph_replays"],
                st["eager_pre_read"]) == (0, 0, 0)
        return
    assert first.pre_read_graphs is sess._pool.pre_read_graphs
    # Keys: one tier lane each, two each, one GROUP BY block.
    assert st["graph_captures"] == 3 == st["eager_pre_read"]
    assert st["graph_replays"] == st["fused_dispatches"] - 3


def test_cpu_pool_takes_no_graph_path():
    data = _data("cpu")
    pool = LanePool(data, lanes=2, **POOL_KW,
                    pre_read_graphs=PreReadGraphs())
    assert pool.pre_read_graphs is None
    pool.submit(Query("avg", epsilon=0.1), key=keys.prng_key(1))
    (r,) = pool.drain()
    assert r.success


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_sharded_pool_counts_its_phases_eager(device):
    """A pool over two data segments replays nothing: every tick's
    pre-read phase runs eagerly in the sharded step and counts as eager, so
    the share of phases replayed reads 0."""
    data = _data(device)
    cache = _cache(device)
    pool = LanePool(data, lanes=2, data_shards=2, mesh=False, **POOL_KW,
                    pre_read_graphs=cache)
    pool.pre_read_graphs = cache        # a CPU pool makes none itself
    ks = keys.split(keys.prng_key(14), 3)
    for spec, k in zip(SOLO[:3], ks):
        _submit((pool,), spec, k)
    assert len(pool.drain()) == 3
    assert cache.captures == cache.replays == 0
    assert cache.eager == _phases(pool) > 0


def test_sharded_step_refuses_graphs():
    state = init_lane_state(keys.split(keys.prng_key(0), 1), 1, n_cap=8,
                            c_dim=1, p_dim=1, n_min=1, max_iters=2,
                            device="cpu")
    with pytest.raises(ValueError, match="eagerly"):
        fused_step(torch.zeros((8, 1)), [0, 8], state, None, data_shards=2,
                   graphs=PreReadGraphs())
