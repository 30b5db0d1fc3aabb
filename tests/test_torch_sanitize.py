"""The runtime sanitizer (``core/sanitize.py``) and the pool's steady-state
sentinel, the port's mirror of ``tests/test_serve_session.py``'s
``test_steady_state_serving_never_recompiles``.

On the CPU the transfer guard is inert (nothing synchronizes with a
device); the root lock and the program-cache sentinel hold everywhere.  The
``cuda`` tests show the guard's teeth on a card: ``.item()`` inside
``no_implicit_sync`` raises, and ``harvest()`` allows it; and the pool's
guarded rounds stay clean on the card along the sharded step (a pool over
two data segments on one card, the path of a ``data_shards`` session) and
the shed of a queued ticket whose deadline passed (the SLO pool's pilot,
run inside ``tick``).  This file imports no JAX.
"""
import time
import types

import numpy as np
import pytest
import torch

from repro_torch.aqp.query import Query, Request
from repro_torch.core import keys, sanitize
from repro_torch.data import make_grouped
from repro_torch.kernels import nvcc
from repro_torch.serve import AQPSession, Planner, Route
from repro_torch.serve import lane_pool as tlp
from repro_torch.serve.lane_pool import LanePool

SESSION_KW = dict(B=100, n_min=300, n_max=600, max_iters=16, n_cap=1 << 13,
                  seed=0, reshuffle_every=1000)
POOL_KW = dict(B=100, n_min=300, n_max=600, l=6, max_iters=16, n_cap=1 << 13,
               ext_cap=1 << 10, seed=0)


@pytest.fixture(scope="module")
def data():
    return make_grouped(["normal", "exp"], 60_000, seed=1, biases=[5.0, 3.0],
                        device="cpu")


@pytest.mark.parametrize("value,on", [("", False), ("0", False),
                                      ("off", False), ("1", True),
                                      ("yes", True)])
def test_enabled_reads_the_environment(monkeypatch, value, on):
    monkeypatch.setenv("MISS_SANITIZE", value)
    assert sanitize.enabled() is on


def test_no_new_roots_refuses_and_restores(monkeypatch):
    monkeypatch.setenv("MISS_SANITIZE", "1")
    k = keys.prng_key(3)
    with sanitize.no_new_roots():
        keys.split(k, 2)                       # derived keys are fine
        with pytest.raises(sanitize.SanitizerError, match="PRNG root"):
            keys.prng_key(4)
    assert np.array_equal(keys.prng_key(3), k)
    monkeypatch.setenv("MISS_SANITIZE", "")
    with sanitize.no_new_roots():
        keys.prng_key(4)                       # inert when disabled


def test_compile_sentinel_counts_library_builds_and_loads(monkeypatch):
    monkeypatch.setenv("MISS_SANITIZE", "1")
    with sanitize.compile_sentinel():
        pass
    monkeypatch.setattr(nvcc.Library, "loads", nvcc.Library.loads)
    with pytest.raises(sanitize.SanitizerError, match="1 CUDA library"):
        with sanitize.compile_sentinel():
            nvcc.Library.loads += 1
    monkeypatch.setattr(nvcc.Library, "builds", nvcc.Library.builds)
    with pytest.raises(sanitize.SanitizerError, match="2 CUDA libraries"):
        with sanitize.compile_sentinel():
            nvcc.Library.builds += 2


def test_guard_is_inert_on_the_cpu(monkeypatch):
    monkeypatch.setenv("MISS_SANITIZE", "1")
    x = torch.ones(3)
    with sanitize.guarded(), sanitize.steady_state():
        assert float(x.sum().item()) == 3.0
        with sanitize.harvest():
            assert x.cpu().numpy().sum() == 3.0


def _pump_done(sess, tickets):
    done = {}
    while True:
        for i, t in enumerate(tickets):
            if i not in done:
                r = sess.poll(t)
                if r is not None:
                    done[i] = r
        if len(done) == len(tickets):
            return [done[i] for i in range(len(tickets))]
        sess.pump()


def _serve(data, sanitized: bool, monkeypatch):
    """Warm-up (one request per estimator family), then a steady stream of
    12 requests interleaved with pumps -- under ``steady_state`` when
    ``sanitized``.  Returns the steady answers and the pool."""
    monkeypatch.setenv("MISS_SANITIZE", "1" if sanitized else "")
    sess = AQPSession(data, planner=Planner(mode=Route.POOL, pool_lanes=2,
                                            pool_ticks_per_sync=1),
                      **SESSION_KW)
    wkeys = keys.split(keys.prng_key(7), 2)
    _pump_done(sess, [
        sess.submit(Request(query=Query(func=f, epsilon=0.3)), key=k)
        for f, k in zip(("avg", "var"), wkeys)])
    qkeys = keys.split(keys.prng_key(23), 12)
    events0 = sanitize.program_events()
    with sanitize.steady_state():
        tickets = []
        for i, k in enumerate(qkeys):
            f = ("avg", "var")[i % 2]
            tickets.append(sess.submit(
                Request(query=Query(func=f, epsilon=0.25)), key=k))
            sess.pump()                 # interleave admission with ticking
        rs = _pump_done(sess, tickets)
    assert sanitize.program_events() == events0
    return rs, sess._pool


def test_steady_state_serving_never_recompiles(data, monkeypatch):
    """After warmup a submit/pump/poll loop runs under the full sanitizer
    (transfer guard, root lock, program sentinel), the pool's
    ``steady_recompiles`` stays 0, and the answers are bit for bit those of
    the same loop unsanitized."""
    rs, pool = _serve(data, True, monkeypatch)
    assert all(r.route is Route.POOL for r in rs)
    assert all(r.success for r in rs)
    assert pool.stats()["steady_recompiles"] == 0
    plain, _ = _serve(data, False, monkeypatch)
    for a, b in zip(rs, plain):
        assert np.asarray(a.theta).tobytes() == np.asarray(b.theta).tobytes()
        assert np.float32(a.error).tobytes() == np.float32(b.error).tobytes()
        assert np.array_equal(a.n, b.n)


def test_steady_recompiles_counts_a_library_loaded_mid_stream(data,
                                                              monkeypatch):
    """The pool's sentinel: a CUDA library built or loaded after the first
    round counts as a steady-state recompile."""
    monkeypatch.setattr(nvcc.Library, "loads", nvcc.Library.loads)
    sess = AQPSession(data, planner=Planner(mode=Route.POOL, pool_lanes=2,
                                            pool_ticks_per_sync=1),
                      **SESSION_KW)
    t = sess.submit(Request(query=Query(func="avg", epsilon=0.02)),
                    key=keys.prng_key(5))
    sess.pump()
    assert sess.poll(t) is None            # still in its lane
    nvcc.Library.loads += 1
    _pump_done(sess, [t])
    assert sess._pool.stats()["steady_recompiles"] == 1


@pytest.mark.cuda
def test_item_raises_inside_the_guard_and_harvest_allows_it(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("MISS_SANITIZE", "1")
    x = torch.ones(4, device="cuda")
    with sanitize.no_implicit_sync():
        y = x * 2                                  # no sync: fine
        with pytest.raises(RuntimeError, match="synchroniz"):
            y.sum().item()
        with sanitize.harvest():
            assert y.sum().item() == 8.0
        with pytest.raises(RuntimeError, match="synchroniz"):
            y.cpu()
    assert torch.cuda.get_sync_debug_mode() == 0
    assert x.sum().item() == 4.0


def _card_data():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return make_grouped(["normal", "exp"], 60_000, seed=1, biases=[5.0, 3.0],
                        device="cuda")


def _same_answers(got, want):
    assert [r.qid for r in got] == [r.qid for r in want]
    for a, b in zip(got, want):
        assert np.asarray(a.theta).tobytes() == np.asarray(b.theta).tobytes()
        assert np.float32(a.error).tobytes() == np.float32(b.error).tobytes()
        assert np.array_equal(a.n, b.n)


@pytest.mark.cuda
def test_cuda_sharded_pool_rounds_pass_the_guard(monkeypatch):
    """A pool over two data segments on one card (``data_shards=2``,
    ``mesh=False``: the sharded step body), after a warm-up, drains a
    steady stream under ``steady_state`` (each round also under the
    transfer guard), with ``steady_recompiles`` 0 and the answers of the
    same stream unsanitized."""
    data = _card_data()

    def serve(sanitized):
        monkeypatch.setenv("MISS_SANITIZE", "1" if sanitized else "")
        pool = LanePool(data, lanes=2, data_shards=2, mesh=False, **POOL_KW)
        for f, k in zip(("avg", "var"), keys.split(keys.prng_key(7), 2)):
            pool.submit(Query(f, epsilon=0.3), key=k)
        pool.drain()
        qk = keys.split(keys.prng_key(23), 4)
        with sanitize.steady_state():
            for i, k in enumerate(qk):
                pool.submit(Query(("avg", "var")[i % 2], epsilon=0.25),
                            key=k)
            out = pool.drain()
        return out, pool.stats()

    got, st = serve(True)
    want, _ = serve(False)
    assert len(got) == 4 and all(r.success for r in got)
    assert st["steady_recompiles"] == 0
    _same_answers(got, want)


@pytest.mark.cuda
def test_cuda_queued_shed_inside_tick_passes_the_guard(monkeypatch):
    """An SLO pool (``degrade=True``) whose queued ticket's deadline passes
    behind busy lanes sheds it at the next round, run under
    ``steady_state``: the pilot's uploads and read are named transfers, so
    the round does not raise."""
    data = _card_data()
    now = [time.perf_counter()]
    monkeypatch.setattr(tlp, "time",
                        types.SimpleNamespace(perf_counter=lambda: now[0]))
    monkeypatch.setenv("MISS_SANITIZE", "1")
    pool = LanePool(data, lanes=2, tiers=1, degrade=True, **POOL_KW)
    k0, k1, k2 = keys.split(keys.prng_key(31), 3)
    q0 = pool.submit(Query("avg", epsilon=0.02), key=k0)
    q1 = pool.submit(Query("avg", epsilon=0.02), key=k1)
    pool.tick()
    assert pool.busy_lanes == 2
    q2 = pool.submit(Query("avg", epsilon=0.05), key=k2,
                     deadline_at=now[0] + 10.0)
    assert pool.queue_depth == 1
    now[0] += 20.0                     # the deadline passes in the queue
    with sanitize.steady_state():
        pool.tick()
    r = pool.results.pop(q2)
    assert r.shed and r.error <= r.delivered_epsilon
    out = pool.drain()
    assert {o.qid for o in out} == {q0, q1}
    assert pool.stats()["shed"] == 1
    assert pool.stats()["steady_recompiles"] == 0
