"""CUDA graphs of the fused tick's phases around its host read.

A tick of :func:`~.fused.fused_step` is hundreds of small kernels around one
host read (the bucket index and the active lanes, or a GROUP BY block's
stream lengths).  Two of its phases have shapes that follow from statics
alone, so each is captured once as a CUDA graph and replayed:

* the pre-read phase (:class:`PreReadGraphs`): FIT, PREDICT, the windows and
  the seeds, which read a few small leaves of the carried state and the
  lane parameters and nothing else (~370 kernels);
* the finish-and-test phase (:class:`FinishGraphs`): the bootstrap finish
  from the replicate moment sums (dead-replicate guard, per-lane estimator
  finish, joint metric, quantile) and TEST with the state merge (~140
  kernels).  The moment sums before it stay eager: their width and stream
  lengths come from the host read, and the bootstrap kernels are called
  through their wrappers, which count every launch.

A cache keeps one graph a key.  The key is made of shapes and statics only,
never of tensor identity, so every tier of a pool, every pool the planner
rebuilds and every GROUP BY block of one shape replay one capture.  A graph
reads static input buffers, refreshed with ``copy_`` before each replay, and
may also read tensors it holds in place (the finish phase reads the
pre-read graph's static inputs and outputs of the same key, refreshed by
that graph's replay earlier in the same tick).  The eager run before a
capture also makes the phase's cached uploads, since nothing may upload
inside a capture.  A replay overwrites the outputs of the last replay of its
key: the pre-read phase's are consumed before the next replay, and the
finish phase's, which become carried state, are cloned out of the graph.
Every graph of a pool draws from one memory pool.

The lane pool owns a :class:`PreReadGraphs` on a CUDA device, which owns
the :class:`FinishGraphs` as ``finish`` (a session shares its own across
pool rebuilds).  Every other caller runs the phases eagerly.  The
counters of engagement: ``replays / (replays + eager)`` is the share of a
card pool's phases that replayed.
"""
from __future__ import annotations

from typing import (Callable, Dict, Hashable, NamedTuple, Optional, Sequence,
                    Tuple)

import torch

from . import sanitize, trace

__all__ = ["FinishGraphs", "PhaseGraphs", "PreReadGraphs"]


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple        # the static input buffers the graph reads
    out: object          # the captured outputs, refreshed by each replay


class _MemoryPool:
    """One CUDA graph memory pool, made at the first capture and shared by
    every cache handed it."""

    def __init__(self):
        self._handle = None

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle


class PhaseGraphs:
    """One CUDA graph a key of one phase of the tick, with the counters of
    engagement: ``captures``, ``replays`` and ``eager``, the phases a card
    pool ran eagerly (the first of each key, before its capture, and each
    tick of a sharded pool, whose step has no graph path).  ``CAPTURE`` and
    ``REPLAY`` name the spans of a capture and of a replay's launch;
    ``COPY_OUT`` clones the outputs of a replay, for a caller that keeps
    them."""

    CAPTURE = REPLAY = ""
    COPY_OUT = False

    def __init__(self, pool: Optional[_MemoryPool] = None):
        self._graphs: Dict[Hashable, _Graph] = {}
        self._pool = pool if pool is not None else _MemoryPool()
        self.captures = 0
        self.replays = 0
        self.eager = 0

    def run(self, key: Hashable, fn: Callable,
            inputs: Sequence[torch.Tensor],
            held: Optional[Callable[[], Tuple[Sequence, Sequence]]] = None):
        """``fn(*inputs, *held)``: replayed from the graph of ``key``, or,
        the first time, run eagerly and then captured.  ``held()``, asked
        only then, gives the tensors the graph reads in place (the same for
        every replay of ``key``) and what they stand for in this call, which
        the eager run reads; without it ``fn`` takes ``inputs`` alone.
        ``fn`` reads no tensor but its arguments and launches the same
        kernels for every call of one key."""
        g = self._graphs.get(key)
        if g is None:
            kept, live = held() if held is not None else ((), ())
            out = fn(*inputs, *live)
            self.eager += 1
            with sanitize.harvest(self.CAPTURE):
                self._graphs[key] = self._capture(fn, inputs, kept)
            self.captures += 1
            return out
        for dst, src in zip(g.inputs, inputs):
            dst.copy_(src)
        with trace.span(self.REPLAY):
            g.graph.replay()
        self.replays += 1
        if self.COPY_OUT:
            return tuple(x.clone() for x in g.out)
        return g.out

    def captured(self, key: Hashable) -> Tuple[tuple, object]:
        """The static input buffers and the outputs of the graph of
        ``key``, which its replays refresh in place."""
        g = self._graphs[key]
        return g.inputs, g.out

    def _capture(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 held: Sequence) -> _Graph:
        static = tuple(x.clone() for x in inputs)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool.handle()):
            out = fn(*static, *held)
        return _Graph(graph, static, out)


class FinishGraphs(PhaseGraphs):
    """The finish-and-test phase's graphs, owned by the
    :class:`PreReadGraphs` whose buffers they read in place and whose
    memory pool they share.  A replay's outputs are cloned out: they become
    carried state, which a later replay of the key must not overwrite.

    It holds the pool, not its owner: a reference cycle would leave both
    caches and their CUDA graphs to Python's cyclic collector, which may
    run inside another capture, where a graph's destructor invalidates
    it."""

    CAPTURE = "lane_pool.step.finish_capture"
    REPLAY = "lane_pool.step.finish_replay"
    COPY_OUT = True


class PreReadGraphs(PhaseGraphs):
    """The pre-read phase's graphs: FIT, PREDICT, windows and seeds; and,
    as ``finish``, the finish-and-test phase's graphs of the same ticks."""

    CAPTURE = "lane_pool.step.capture"
    REPLAY = "lane_pool.step.replay"

    def __init__(self):
        super().__init__()
        self.finish = FinishGraphs(self._pool)
