"""Learned warm start and answer cache of the serving session.

An in-process LRU keyed by a query's
:func:`~repro_torch.aqp.query.cache_signature` keeps what a completed run
learned:

* the fitted coefficients ``beta`` of ``log e = b0 - sum b_i log n_i``
  (epsilon-independent, so one entry predicts ``n*`` for any bound of the
  same query shape);
* the converged sizes ``n_star`` and the iteration count;
* for bit-identical repeats (same epsilon and delta, same epoch, no pinned
  key) the exact answer, served at ``poll()`` with zero pool dispatches.

:meth:`WarmCache.lookup`: an exact hit needs an answer at the request's
exact epsilon; otherwise an entry in the same epsilon bucket is a warm
(coefficients) hit; otherwise the nearest other bucket of the same shape.
A warm hit yields a predicted ``n0`` through the closed-form Lagrange
optimum (paper Eq. 13), which the lane verifies in one tick
(``LaneParams.warm`` in ``core/fused.py``).

Entries live inside one sample epoch: a rotation of the slot->row binding
drops them all (counted ``stale``).  The cache is bounded in entries and
bytes, LRU over both.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np

from ..aqp.query import Query, cache_signature

# Safety factor applied to model-predicted warm sizes: overshooting by a
# hair converts "verify, miss by 2%, extend, verify" (two ticks) into one
# tick, at a marginal sampled-rows cost.  Exact-epsilon repeats take the
# stored n_star (the size that actually converged) instead.
WARM_MARGIN = 1.10


@dataclasses.dataclass
class CachedAnswer:
    """The exact answer of one completed run (bit-replayable).

    A GROUPED run's answer additionally carries the per-group error
    quantiles and verdicts (``error``/``success`` hold the scalar summary:
    max error over groups, conjunction of verdicts)."""
    theta: np.ndarray
    error: float
    success: bool
    n: np.ndarray
    epsilon: float          # the exact bound this answer satisfied
    group_error: Optional[np.ndarray] = None     # (G,) grouped runs only
    group_success: Optional[np.ndarray] = None   # (G,)


@dataclasses.dataclass
class WarmEntry:
    """What one completed run taught the cache.

    Solo entries hold the ``(m+1,)`` joint-profile coefficients; GROUPED
    entries hold ``(G, 2)`` per-group rows (each group fits its OWN log-log
    model in its lane) with ``n_star (G,)`` -- ``beta.ndim`` discriminates.
    """
    beta: np.ndarray        # (m+1,) solo | (G, 2) grouped coefficients
    n_star: np.ndarray      # (m,) | (G,) final converged sizes
    iterations: int         # iterations the producing run took (max over
                            #   groups for a grouped entry)
    epsilon: float          # the producing run's exact bound
    answer: Optional[CachedAnswer] = None

    @property
    def nbytes(self) -> int:
        n = self.beta.nbytes + self.n_star.nbytes + 64
        if self.answer is not None:
            a = self.answer
            n += a.theta.nbytes + a.n.nbytes + 64
            for arr in (a.group_error, a.group_success):
                if arr is not None:
                    n += arr.nbytes
        return n


class WarmCache:
    """Bounded LRU of :class:`WarmEntry` rows keyed by query signature.

    Keys are ``(shape, bucket)`` pairs from ``cache_signature`` -- the
    epsilon-free query shape plus the geometric epsilon bucket.  A
    secondary shape index supports the near-repeat fallback (same shape,
    different bucket) without scanning the LRU.
    """

    def __init__(self, max_entries: int = 256,
                 max_bytes: int = 8 << 20) -> None:
        self.max_entries = int(max_entries)
        self.max_bytes = int(max_bytes)
        self._entries: "OrderedDict[Tuple, WarmEntry]" = OrderedDict()
        self._shapes: Dict[Tuple, set] = {}     # shape -> {bucket, ...}
        self._bytes = 0
        self.epoch = 0
        # Counters (the stats() contract).
        self.hits = 0           # exact + warm
        self.exact_hits = 0
        self.warm_hits = 0
        self.misses = 0
        self.evictions = 0      # capacity-pressure drops
        self.stale = 0          # epoch-rotation drops
        self.insertions = 0

    # -- introspection ------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes_used(self) -> int:
        return self._bytes

    def stats(self) -> Dict[str, float]:
        return {
            "entries": len(self._entries),
            "bytes": self._bytes,
            "max_entries": self.max_entries,
            "max_bytes": self.max_bytes,
            "epoch": self.epoch,
            "hits": self.hits,
            "exact_hits": self.exact_hits,
            "warm_hits": self.warm_hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "stale": self.stale,
            "insertions": self.insertions,
        }

    # -- invalidation -------------------------------------------------------
    def rotate_epoch(self) -> None:
        """Sample-key rotation landed: every entry's rows are now drawn
        under a dead slot->row binding -- drop them all (counted stale)."""
        self.stale += len(self._entries)
        self._entries.clear()
        self._shapes.clear()
        self._bytes = 0
        self.epoch += 1

    # -- lookup / insert ----------------------------------------------------
    def signature(self, query: Query,
                  num_groups: Optional[int] = None
                  ) -> Optional[Tuple[Tuple, int]]:
        """The query's cache identity under the CURRENT epoch (None =
        uncacheable: opaque callable predicate).  Grouped queries require
        the dataset's ``num_groups`` -- their signatures carry the grouping
        cardinality so a grouped entry never collides with the solo entry
        of the same clause."""
        return cache_signature(query, dataset_epoch=self.epoch,
                               num_groups=num_groups)

    def lookup(self, sig: Optional[Tuple[Tuple, int]], *,
               epsilon: float) -> Tuple[str, Optional[WarmEntry]]:
        """Resolve one request: ``("exact", entry)`` when the entry holds an
        answer at this exact epsilon, ``("warm", entry)`` for a coefficient
        hit (same bucket first, nearest other bucket of the same shape as
        fallback), ``("miss", None)`` otherwise.  Touches LRU recency on
        hits; every call increments exactly one counter."""
        if sig is None:
            self.misses += 1
            return "miss", None
        shape, bucket = sig
        entry = self._entries.get(sig)
        if entry is not None:
            self._entries.move_to_end(sig)
            if (entry.answer is not None
                    and entry.answer.epsilon == float(epsilon)):
                self.hits += 1
                self.exact_hits += 1
                return "exact", entry
            self.hits += 1
            self.warm_hits += 1
            return "warm", entry
        # Near-repeat fallback: any other bucket of the same shape carries
        # usable coefficients (the log-log model is epsilon-independent);
        # prefer the numerically nearest bucket.
        buckets = self._shapes.get(shape)
        if buckets:
            near = min((b for b in buckets if b != bucket),
                       key=lambda b: abs(b - bucket), default=None)
            if near is not None:
                key = (shape, near)
                self._entries.move_to_end(key)
                self.hits += 1
                self.warm_hits += 1
                return "warm", self._entries[key]
        self.misses += 1
        return "miss", None

    def insert(self, sig: Optional[Tuple[Tuple, int]],
               entry: WarmEntry) -> None:
        """Store (or refresh) one completed run's entry; evicts LRU rows
        until both bounds hold."""
        if sig is None:
            return
        old = self._entries.pop(sig, None)
        if old is not None:
            self._bytes -= old.nbytes
        self._entries[sig] = entry
        self._bytes += entry.nbytes
        self._shapes.setdefault(sig[0], set()).add(sig[1])
        self.insertions += 1
        while self._entries and (
                len(self._entries) > self.max_entries
                or self._bytes > self.max_bytes):
            if len(self._entries) == 1 and len(self._entries) <= \
                    self.max_entries:
                break       # a single oversized entry is kept (progress)
            key, ev = self._entries.popitem(last=False)
            self._bytes -= ev.nbytes
            self.evictions += 1
            buckets = self._shapes.get(key[0])
            if buckets is not None:
                buckets.discard(key[1])
                if not buckets:
                    del self._shapes[key[0]]

    # -- prediction ---------------------------------------------------------
    def predict_n0(self, entry: WarmEntry, *, epsilon: float,
                   n_min: int) -> np.ndarray:
        """The warm lane's tick-0 jump target for a bound of ``epsilon``.

        Exact-epsilon repeats reuse the stored ``n_star`` (the size that
        actually converged -- strictly better than the model's optimum,
        which converged runs typically overshoot by one refinement).  Any
        other bound goes through the closed-form Lagrange optimum (paper
        Eq. 13) on the cached coefficients, padded by :data:`WARM_MARGIN`
        so borderline predictions verify in one tick.  Non-finite model
        output (e.g. a degenerate cached fit) falls back to ``n_star``.
        """
        if float(epsilon) == entry.epsilon:
            return np.maximum(entry.n_star.astype(np.int64), n_min)
        if entry.beta.ndim == 2:
            # Grouped entry: (G, 2) per-group (b0, b1) rows, each its own
            # single-variable model -- the Lagrange optimum decouples into
            # G scalar inversions ``n_g = exp((b0_g - log eps) / b1_g)``.
            b0 = entry.beta[:, 0].astype(np.float64)
            b = np.maximum(entry.beta[:, 1].astype(np.float64), 1e-9)
            with np.errstate(over="ignore"):
                n_hat = np.exp((b0 - np.log(float(epsilon))) / b)
            n0 = np.where(np.isfinite(n_hat),
                          np.ceil(n_hat * WARM_MARGIN),
                          entry.n_star).astype(np.int64)
            return np.maximum(n0, n_min)
        b0, b = float(entry.beta[0]), np.maximum(
            entry.beta[1:].astype(np.float64), 1e-9)
        s = float(b.sum())
        log_lambda = (b0 - float((b * np.log(b)).sum())
                      - np.log(float(epsilon))) / s
        with np.errstate(over="ignore"):
            n_hat = b * np.exp(log_lambda)
        if not np.all(np.isfinite(n_hat)):
            return np.maximum(entry.n_star.astype(np.int64), n_min)
        n0 = np.ceil(n_hat * WARM_MARGIN).astype(np.int64)
        return np.maximum(n0, n_min)
