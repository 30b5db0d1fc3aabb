"""The port's serving-path spans (``core/trace.py``) and the per-answer
counters of ``SessionResponse``.

* with no profiler recording, :func:`trace.span` hands back the shared
  no-op and never builds a ``record_function``, whatever the serve does;
* under ``torch.profiler`` (CPU activity) a small ``AQPSession`` serving
  solo and GROUP BY requests through its pool names every span
  ``session.*`` or ``lane_pool.*``, nests the tick's phases inside their
  tier or block step, inside ``lane_pool.tick``, inside ``session.pump``,
  and opens one ``lane_pool.step.read`` a tick of every busy tier and
  block;
* the answers are bit-equal with the profiler on and off;
* ``SessionResponse.iterations`` / ``.ticks`` are the pool's own counts.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.aqp.query import Query, Request
from repro_torch.core import sanitize, trace
from repro_torch.core.sampling import GroupedData
from repro_torch.serve import (AQPSession, GroupPoolResponse, Planner,
                               Route)

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
PREFIXES = ("session.", "lane_pool.")
STEPS = ("lane_pool.tier_step", "lane_pool.block_step")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per test worker keeps
    parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


G = 3
SESSION_KW = dict(B=64, n_min=200, n_max=400, max_iters=16, n_cap=1 << 12,
                  seed=5, reshuffle_every=1000)
REQUESTS = [dict(func="avg", epsilon=0.1, group_by=True),
            dict(func="avg", epsilon=0.065),
            dict(func="sum", epsilon=400.0),
            dict(func="std", epsilon=0.1, group_by=True),
            dict(func="var", epsilon=0.2),
            dict(func="avg", epsilon=0.08)]


def _data() -> GroupedData:
    rng = np.random.default_rng(11)
    sizes = (3000, 4500, 2500)
    vals = np.concatenate([rng.normal(4.0 + g, 1.0 + 0.3 * g, size=n)
                           for g, n in enumerate(sizes)]).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    return GroupedData(torch.from_numpy(vals[:, None]), offsets,
                       device="cpu")


def _serve(ticks_per_sync: int = 1, pool_log=None):
    """The requests through a forced-POOL session, two arrivals a pump;
    returns the session and its responses in rid order.  ``pool_log``
    collects every pool response as the session harvests it."""
    sess = AQPSession(_data(), planner=Planner(
        mode=Route.POOL, pool_lanes=4, pool_ticks_per_sync=ticks_per_sync),
        **SESSION_KW)
    if pool_log is not None:
        harvest = sess._harvest_pool

        def spy():
            if sess._pool is not None:
                pool_log.update({sess._pool_rids[q]: r for q, r
                                 in sess._pool.results.items()})
            harvest()
        sess._harvest_pool = spy
    for i, r in enumerate(REQUESTS):
        sess.submit(Request(query=Query(**r)))
        if i % 2:
            sess.pump()
    return sess, sess.drain()


def _spans(prof):
    """(name, start, end) ns of every user annotation of the profile."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation()]


def _ancestors(spans, span):
    """The spans enclosing ``span``, innermost first."""
    name, s, e = span
    out = [x for x in spans if x is not span and x[1] <= s and e <= x[2]]
    return sorted(out, key=lambda x: x[2] - x[1])


@pytest.fixture(scope="module", params=[1, 2], ids=["tps1", "tps2"])
def traced(request):
    """The serve under the profiler, and the same serve without it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess, traced = _serve(request.param)
    _, plain = _serve(request.param)
    return dict(sess=sess, spans=_spans(prof), traced=traced, plain=plain,
                tps=request.param)


def test_span_off_is_the_shared_noop(monkeypatch):
    """No profiler: ``span`` and a named ``harvest`` never build a
    ``record_function``, and a whole serve runs without one."""
    def refuse(*a, **k):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    assert trace.span("lane_pool.tick") is trace.OFF
    with sanitize.harvest("lane_pool.step.read"), sanitize.harvest():
        pass
    _, res = _serve()
    assert len(res) == len(REQUESTS) and all(r.success for r in res)


def test_span_under_the_profiler_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("session.pump"):
            with sanitize.harvest("lane_pool.harvest.read"):
                pass
    names = [n for n, _, _ in _spans(prof)]
    assert names == ["session.pump", "lane_pool.harvest.read"]


def test_every_span_name_in_the_program_has_a_prefix():
    """Every literal span or named-harvest name in the port's source: a
    reader drops the device-side copies of spans by these prefixes."""
    pat = re.compile(r"(?:trace\.span|sanitize\.harvest)\(\s*\"([^\"]*)\"")
    names = {n for p in SRC.rglob("*.py") for n in pat.findall(p.read_text())}
    assert len(names) >= 20
    assert all(n.startswith(PREFIXES) for n in names), sorted(names)
    assert all(not n.endswith((".read", ".upload")) or n.count(".") >= 2
               for n in names)


def test_traced_serve_names_every_span_with_a_prefix(traced):
    names = {n for n, _, _ in traced["spans"]}
    assert names and all(n.startswith(PREFIXES) for n in names), names
    for want in ("session.pump", "session.retune", "session.admit",
                 "session.harvest", "lane_pool.tick", "lane_pool.refill",
                 "lane_pool.refill.upload", "lane_pool.harvest",
                 "lane_pool.harvest.read", "lane_pool.harvest_blocks",
                 "lane_pool.harvest_blocks.read", *STEPS,
                 "lane_pool.step.fit_predict", "lane_pool.step.read",
                 "lane_pool.step.gather", "lane_pool.step.estimate",
                 "lane_pool.step.test"):
        assert want in names, want


def test_tick_phases_nest_in_step_tick_and_pump(traced):
    spans = traced["spans"]
    n_steps = {s: 0 for s in STEPS}
    for sp in spans:
        name = sp[0]
        up = [a[0] for a in _ancestors(spans, sp)]
        if name.startswith("lane_pool.step."):
            # The first ancestor that is no phase is the tier or block step.
            outer = [a for a in up if not a.startswith("lane_pool.step.")]
            assert outer[:3] in ([s, "lane_pool.tick", "session.pump"]
                                 for s in STEPS), (name, up)
            n_steps[outer[0]] += 1
        elif name in STEPS:
            assert up[:2] == ["lane_pool.tick", "session.pump"], up
        elif name == "lane_pool.tick":
            assert up == ["session.pump"], up
    assert all(n_steps.values()), n_steps


def test_one_step_read_a_tick_of_every_busy_tier_and_block(traced):
    """``lane_pool.step.read`` spans == ticks x (busy tiers + blocks): the
    pool's dispatch count (one a busy tier and a block a round) times its
    ticks a round."""
    sess, spans, tps = traced["sess"], traced["spans"], traced["tps"]
    pool = sess._pool
    assert sess.pool_rebuilds == 0 and pool.ticks_per_sync == tps
    reads = sum(n == "lane_pool.step.read" for n, _, _ in spans)
    assert pool.block_ticks > 0 and pool.dispatches > pool.block_ticks // tps
    assert reads == pool.dispatches * tps
    # A block's reads nest in its block steps, the tiers' in theirs.
    in_blocks = sum(
        sp[0] == "lane_pool.step.read"
        and _ancestors(spans, sp)[0][0] == "lane_pool.block_step"
        for sp in spans)
    assert in_blocks == pool.block_ticks


def test_answers_bit_equal_with_the_profiler_on_and_off(traced):
    a, b = traced["traced"], traced["plain"]
    assert len(a) == len(b) == len(REQUESTS)
    for x, y in zip(a, b):
        assert x.route is y.route is Route.POOL
        assert np.array_equal(np.asarray(x.n), np.asarray(y.n))
        assert np.array_equal(np.asarray(x.theta), np.asarray(y.theta))
        assert x.error == y.error and x.success == y.success
        assert (x.iterations, x.ticks) == (y.iterations, y.ticks)
        assert x.rows_sampled == y.rows_sampled


@pytest.mark.parametrize("tps", [1, 2])
def test_response_counters_are_the_pools(tps):
    log = {}
    _, res = _serve(tps, pool_log=log)
    assert sorted(log) == [r.rid for r in res]
    grouped = 0
    for r in res:
        p = log[r.rid]
        if isinstance(p, GroupPoolResponse):
            grouped += 1
            assert r.group_by and r.ticks == p.ticks_in_block
            assert r.iterations == int(np.max(p.iterations))
        else:
            assert r.ticks == p.ticks_in_lane
            assert r.iterations == p.iterations
        assert 1 <= r.iterations <= r.ticks
        assert r.ticks % tps == 0
    assert grouped == 2


def test_counters_off_the_pool():
    """LOOP answers carry MISS's iterations and no pool ticks."""
    sess = AQPSession(_data(), planner=Planner(mode=Route.LOOP),
                      **SESSION_KW)
    sess.submit(Request(query=Query(func="avg", epsilon=0.08)))
    (r,) = sess.drain()
    assert r.route is Route.LOOP and r.ticks == 0 and r.iterations >= 2
