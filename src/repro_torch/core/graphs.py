"""CUDA graphs of the fused tick's pre-read phase.

A tick of :func:`~.fused.fused_step` is hundreds of small kernels around one
host read (the bucket index and the active lanes, or a GROUP BY block's
stream lengths).  Everything before that read -- FIT, PREDICT, the windows
and the seeds -- reads a few small leaves of the carried state and the lane
parameters and nothing else, and its shapes follow from statics alone.  So
it is captured once as a CUDA graph and replayed: one launch where the host
issued ~370.

:class:`PreReadGraphs` keeps one graph a key.  The key is made of shapes and
statics only, never of tensor identity, so every tier of a pool, every
pool the planner rebuilds and every GROUP BY block of one shape replay one
capture.  A graph reads static input buffers, one a leaf, refreshed with
``copy_`` before each replay; the eager run before a capture also makes the
phase's cached uploads, since nothing may upload inside a capture.  A
replay overwrites the outputs of the last replay of its key: a caller
consumes them before the next replay and carries none into its state
(the step's epilogue builds new tensors from them).  Every graph draws from
one memory pool, freed with the object.

The lane pool owns one on a CUDA device (a session shares its own across
pool rebuilds).  Every other caller runs the phase eagerly.  The counters
of engagement: ``replays / (replays + eager)`` is the share of a card
pool's pre-read phases that replayed.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, NamedTuple, Sequence

import torch

from . import sanitize, trace

__all__ = ["PreReadGraphs"]


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple        # the static input buffers the graph reads
    out: object          # the captured outputs, refreshed by each replay


class PreReadGraphs:
    """One CUDA graph a key of the tick's pre-read phase, with the counters
    of engagement: ``captures``, ``replays`` and ``eager``, the phases a
    card pool ran eagerly (the first of each key, before its capture, and
    each tick of a sharded pool, whose step has no graph path)."""

    def __init__(self):
        self._graphs: Dict[Hashable, _Graph] = {}
        self._pool = None           # the graphs' shared memory pool
        self.captures = 0
        self.replays = 0
        self.eager = 0

    def run(self, key: Hashable, fn: Callable,
            inputs: Sequence[torch.Tensor]):
        """``fn(*inputs)``: replayed from the graph of ``key``, or, the
        first time, run eagerly and then captured.  ``fn`` reads no tensor
        but ``inputs`` and launches the same kernels for every call of one
        key."""
        g = self._graphs.get(key)
        if g is None:
            out = fn(*inputs)
            self.eager += 1
            with sanitize.harvest("lane_pool.step.capture"):
                self._graphs[key] = self._capture(fn, inputs)
            self.captures += 1
            return out
        for dst, src in zip(g.inputs, inputs):
            dst.copy_(src)
        with trace.span("lane_pool.step.replay"):
            g.graph.replay()
        self.replays += 1
        return g.out

    def _capture(self, fn: Callable, inputs: Sequence[torch.Tensor]
                 ) -> _Graph:
        static = tuple(x.clone() for x in inputs)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            out = fn(*static)
        return _Graph(graph, static, out)
