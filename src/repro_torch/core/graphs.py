"""CUDA graphs of the fused tick's phases around its host read.

A tick of :func:`~.fused.fused_step` is hundreds of small kernels around one
host read (the bucket index and the active lanes, or a GROUP BY block's
stream lengths).  Two of its phases have shapes that follow from statics
alone, so each is captured once as a CUDA graph and replayed (``fused.py``
declares them, :data:`~.fused.PRE_READ` and :data:`~.fused.FINISH`):

* the pre-read phase: FIT, PREDICT, the windows and the seeds, which read a
  few small leaves of the carried state and the lane parameters and nothing
  else (~370 kernels);
* the finish-and-test phase: the bootstrap finish from the replicate moment
  sums (dead-replicate guard, per-lane estimator finish, joint metric,
  quantile) and TEST with the state merge (~140 kernels).  The moment sums
  before it stay eager: their width and stream lengths come from the host
  read, and the bootstrap kernels are called through their wrappers, which
  count every launch.

A :class:`TickGraphs` keeps one record a tick key, holding the graph of
each phase of that key by its sub-key.  The key is made of shapes and
statics only, never of tensor identity, so every tier of a pool, every pool
the planner rebuilds and every GROUP BY block of one shape replay one
capture.  A graph reads static input buffers, refreshed with ``copy_``
before each replay; a phase may also read in place the inputs and outputs
of an earlier phase of the same tick (:attr:`Phase.reads`: the finish reads
the pre-read graph's, refreshed by that graph's replay earlier in the
tick).  The record resolves those reads: to the graph's buffers for a
capture, and to what the earlier phase ran on this tick for the eager run
before it, which also makes the phase's cached uploads, since nothing may
upload inside a capture.  A replay overwrites the outputs of the last
replay of its graph: the pre-read phase's are consumed before the next
replay, and the finish phase's, which become carried state, are cloned out
(:attr:`Phase.copy_out`).  Every graph of a cache draws from its one memory
pool, and nothing a cache holds refers back to it, so a dropped cache and
its graphs die with their last reference, never inside the cyclic
collector, which may run during another capture (where a graph's
destructor invalidates it).

The lane pool holds a :class:`TickGraphs` on a CUDA device (a session
shares its own across pool rebuilds); every other caller runs the phases
eagerly.  The counters of engagement, by phase: ``replays / (replays +
eager)`` is the share of a card pool's phases that replayed, ``eager``
counting the first run of each key and every tick of a sharded step.
"""
from __future__ import annotations

from collections import Counter, defaultdict
from typing import Callable, Dict, Hashable, NamedTuple, Sequence, Tuple

import torch

from . import sanitize, trace

__all__ = ["FinishGraphs", "Phase", "TickGraphs"]


class Phase(NamedTuple):
    """A phase of the tick that :class:`TickGraphs` replays: the spans of
    its capture and of a replay's launch, whether a replay's outputs are
    cloned out for a caller that keeps them, and the earlier phases of the
    same tick whose inputs and outputs it reads in place."""
    capture: str
    replay: str
    copy_out: bool = False
    reads: Tuple["Phase", ...] = ()


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple        # the static input buffers the graph reads
    out: tuple           # the captured outputs, refreshed by each replay


class _Tick:
    """One tick key's record: its graphs by ``(phase, sub-key)``, and, by
    phase, the operands (inputs, then outputs) of the phase's last run, as
    it ran and as its graph holds them."""

    def __init__(self):
        self.graphs: Dict[Hashable, _Graph] = {}
        self.ran: Dict[Phase, Tuple[tuple, tuple]] = {}


class TickGraphs:
    """One CUDA graph a tick key, phase and sub-key, with the counters of
    engagement by phase: ``captures``, ``replays`` and ``eager``."""

    def __init__(self):
        self._ticks: Dict[Hashable, _Tick] = defaultdict(_Tick)
        self._pool = None                   # made at the first capture
        self.captures: Counter = Counter()
        self.replays: Counter = Counter()
        self.eager: Counter = Counter()

    def run(self, key: Hashable, phase: Phase, fn: Callable,
            inputs: Sequence[torch.Tensor], sub: Hashable = ()):
        """``fn(*inputs, *in_place)``, ``in_place`` the inputs and outputs
        of the phases ``phase.reads`` in this tick of ``key``: replayed
        from the graph of ``(key, phase, sub)``, or, the first time, run
        eagerly and then captured.  ``fn`` reads no tensor but its
        arguments and launches the same kernels for every call of one
        graph."""
        tick = self._ticks[key]
        g = tick.graphs.get((phase, sub))
        if g is None:
            live = [x for r in phase.reads for x in tick.ran[r][0]]
            kept = [x for r in phase.reads for x in tick.ran[r][1]]
            out = fn(*inputs, *live)
            self.eager[phase] += 1
            with sanitize.harvest(phase.capture):
                g = tick.graphs[phase, sub] = self._capture(fn, inputs, kept)
            self.captures[phase] += 1
            tick.ran[phase] = ((*inputs, *out), (*g.inputs, *g.out))
            return out
        for dst, src in zip(g.inputs, inputs):
            dst.copy_(src)
        with trace.span(phase.replay):
            g.graph.replay()
        self.replays[phase] += 1
        tick.ran[phase] = ((*g.inputs, *g.out),) * 2
        return tuple(x.clone() for x in g.out) if phase.copy_out else g.out

    def _capture(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 in_place: Sequence) -> _Graph:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        static = tuple(x.clone() for x in inputs)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            out = fn(*static, *in_place)
        return _Graph(graph, static, out)


# aqpbench/metrics/lane_pool.finish_replay_share.py looks this name up.
FinishGraphs = TickGraphs
