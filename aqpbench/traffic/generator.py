"""The one traffic generator: reads a mix file (``traffic/<mix>.json``) and
draws the requests of a run from ``--seed``.

A mix file holds parameters only:

* ``loop``: ``"open"`` (Poisson arrivals at ``rate_per_s``, independent
  users) or ``"closed"`` (``clients`` that each send their next request the
  moment the previous answer arrives, no think time);
* ``cycle``: the kinds in the order the queue takes them (a mix of one kind
  may leave it out);
* ``levels``: the bound fractions of a func, evenly spaced over its
  ``[lo, hi]``;
* ``warmup_requests``: requests served before the window, from a queue of
  their own, so every path the mix takes is warm;
* ``kinds``: ``{name: kind}``, a kind being ``funcs`` (``{func: [lo,
  hi]}``), ``bound`` (``"norm"``: epsilon = fraction x the L2 norm of the
  func's per-group answers; ``"min_group"``: x the smallest per-group
  answer), and optionally ``group_by`` and ``delta`` (0.05).

Every seed sends the same set of requests in another order: each kind deals
its requests in rounds that hold every func at every level once, each round
in the seed's order.  So the work of a window does not hang on the seed.
Bounds are sized from the population's answers (``data.lineitem.
sizing_values``) and the seed's group sizes, so they do not depend on which
rows the seed drew.
"""
from __future__ import annotations

import itertools
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..data import lineitem


def sizing_answers(values: np.ndarray, sizes: np.ndarray, func: str
                   ) -> np.ndarray:
    """(groups,) population answers of ``func`` that size the bounds, from
    the sizing sample ``values``."""
    x = values.astype(np.float64)
    if func == "sum":
        return x.mean() * sizes.astype(np.float64)
    v = {"avg": x.mean, "var": x.var, "std": x.std}[func]()
    return np.full(sizes.shape, float(v), np.float64)


class Traffic:
    """The requests of one run of a mix on one configuration."""

    def __init__(self, mix: dict, cfg: dict, sizes: np.ndarray, seed: int):
        self.mix = mix
        self.seed_words = lineitem.seed_words(seed)
        self.kinds = mix["kinds"]
        values = lineitem.sizing_values(cfg)
        self._answers = {f: sizing_answers(values, sizes, f)
                         for k in self.kinds.values() for f in k["funcs"]}

    def _rng(self, stream: int) -> np.random.Generator:
        return np.random.default_rng(self.seed_words + [2, int(stream)])

    def _spec(self, name: str, func: str, frac: float) -> dict:
        kind = self.kinds[name]
        th = self._answers[func]
        scale = (np.linalg.norm(th) if kind["bound"] == "norm"
                 else float(np.abs(th).min()))
        return {"kind": name, "func": func,
                "group_by": bool(kind.get("group_by")),
                "delta": float(kind.get("delta", 0.05)),
                "epsilon": frac * float(scale)}

    def _deal(self, name: str, rng: np.random.Generator) -> Iterator[dict]:
        """A kind's requests: rounds of every (func, level), shuffled."""
        levels = int(self.mix["levels"])
        deck = [(f, lo + (hi - lo) * (i + 0.5) / levels)
                for f, (lo, hi) in sorted(self.kinds[name]["funcs"].items())
                for i in range(levels)]
        while True:
            for j in rng.permutation(len(deck)):
                yield self._spec(name, *deck[j])

    def stream(self, stream: int) -> Iterator[dict]:
        """The requests of queue ``stream`` in the order they are sent; the
        clients of a closed loop take turns at one queue."""
        rng = self._rng(stream)
        names = self.mix.get("cycle") or list(self.kinds)
        if len(set(names)) != len(self.kinds):
            raise ValueError("a mix of several kinds names them in `cycle`")
        deals = {n: self._deal(n, rng) for n in set(names)}
        for name in itertools.cycle(names):
            yield next(deals[name])

    def arrivals(self, seconds: float, stream: int = 0,
                 limit: Optional[int] = None) -> List[Tuple[float, dict]]:
        """An open loop's ``(due offset s, spec)``: Poisson arrivals at
        ``rate_per_s``.  A window of ``seconds`` gets ``round(rate *
        seconds)`` of them at uniform times (a Poisson process given its
        count), so every seed offers the same load; without a window the
        first ``limit`` follow exponential gaps."""
        rate = float(self.mix["rate_per_s"])
        times = self._rng(stream + 1_000_000)
        if np.isfinite(seconds):
            due = np.sort(times.uniform(0.0, seconds,
                                        int(round(rate * seconds))))
        else:
            due = np.cumsum(times.exponential(1.0 / rate, int(limit)))
        return list(zip(due.tolist(), self.stream(stream)))
