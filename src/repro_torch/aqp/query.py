"""Approximate analytical queries (paper Listing 1):

    SELECT X, f(Y) FROM D GROUP BY X [WHERE P]
    ERROR WITHIN eps CONFIDENCE 1-delta [METRIC m]

``predicate`` turns a COUNT query into COUNT-with-predicate by mapping the
measure column to an indicator before estimation (paper SS2.1);
``epsilon_rel`` expresses the bound relative to the result's magnitude,
resolved by the engine against a pilot estimate.

A predicate is either an opaque callable over the ``(N, c)`` values tensor
(returning a bool ``(N,)`` tensor) or a structured AST of nested tuples --
``("col", j)`` / ``("lit", x)`` leaves under comparison and boolean nodes
(see :func:`canonicalize_predicate`).  :func:`compile_predicate` turns the
AST into torch comparisons on the values' own device, so a predicate over a
table resident on the card never copies the column to the host.  Two
semantically identical ASTs canonicalize to one signature, which keys the
serving layer's warm cache (:func:`cache_signature`); an opaque callable has
no signature and never hits the cache.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

METRICS = ("l2", "linf", "l1", "lp", "order", "diff")

# -- structured predicates ---------------------------------------------------
# Grammar (nested tuples; a bare int/float is shorthand for ("lit", x)):
#   expr := ("col", j) | ("lit", x)
#         | (cmp, expr, expr)          cmp in {"<", "<=", ">", ">=", "==", "!="}
#         | ("and"|"or", expr, ...)    n-ary, n >= 1
#         | ("not", expr)
_CMP_OPS = ("<", "<=", ">", ">=", "==", "!=")
# Orientation normal form: a > b == b < a, so only "<"/"<=" survive
# canonicalization and the operand order carries the direction.
_FLIP = {">": "<", ">=": "<="}
# Unordered comparisons: operand order is semantically free, so it is
# sorted away.
_SYMMETRIC = ("==", "!=")
_BOOL_OPS = ("and", "or")

PredicateAST = Tuple
Predicate = Union[Callable, PredicateAST]


def canonicalize_predicate(pred) -> PredicateAST:
    """Reduce a predicate AST to its canonical form (raises on malformed).

    Normalizations (each removes one source of signature instability):
      * numeric literals coerce to float (``("lit", 5)`` == ``("lit", 5.0)``),
      * ``>`` / ``>=`` flip into ``<`` / ``<=`` with swapped operands,
      * ``==`` / ``!=`` operands sort (operand order is semantically free),
      * ``and`` / ``or`` flatten nested same-op children, dedupe, and sort;
        single-child nodes collapse to the child,
      * ``not not x`` collapses to ``x``.
    The result is a hashable nested tuple -- the predicate's signature.
    """
    if isinstance(pred, bool):
        raise ValueError(f"bare bool {pred!r} is not a predicate expression")
    if isinstance(pred, (int, float, np.integer, np.floating)):
        return ("lit", float(pred))
    if not isinstance(pred, tuple) or not pred or not isinstance(pred[0], str):
        raise ValueError(f"malformed predicate node: {pred!r}")
    op = pred[0]
    if op == "lit":
        if len(pred) != 2 or not isinstance(
                pred[1], (int, float, np.integer, np.floating)) or isinstance(
                pred[1], bool):
            raise ValueError(f"malformed lit node: {pred!r}")
        return ("lit", float(pred[1]))
    if op == "col":
        if len(pred) != 2 or not isinstance(
                pred[1], (int, np.integer)) or isinstance(pred[1], bool):
            raise ValueError(f"malformed col node: {pred!r}")
        if pred[1] < 0:
            raise ValueError(f"col index must be >= 0: {pred!r}")
        return ("col", int(pred[1]))
    if op == "not":
        if len(pred) != 2:
            raise ValueError(f"'not' takes one operand: {pred!r}")
        inner = canonicalize_predicate(pred[1])
        if inner[0] in ("lit", "col"):
            raise ValueError(f"'not' needs a boolean operand: {pred!r}")
        if inner[0] == "not":
            return inner[1]
        return ("not", inner)
    if op in _CMP_OPS:
        if len(pred) != 3:
            raise ValueError(f"comparison takes two operands: {pred!r}")
        a, b = (canonicalize_predicate(x) for x in pred[1:])
        for side in (a, b):
            if side[0] not in ("lit", "col"):
                raise ValueError(
                    f"comparison operands must be col/lit: {pred!r}")
        if op in _FLIP:
            op, a, b = _FLIP[op], b, a
        elif op in _SYMMETRIC and repr(b) < repr(a):
            a, b = b, a
        return (op, a, b)
    if op in _BOOL_OPS:
        if len(pred) < 2:
            raise ValueError(f"{op!r} takes at least one operand: {pred!r}")
        terms = []
        for t in pred[1:]:
            c = canonicalize_predicate(t)
            if c[0] in ("lit", "col"):
                raise ValueError(f"{op!r} needs boolean operands: {pred!r}")
            # Flatten nested same-op nodes: and(and(a, b), c) == and(a, b, c).
            terms.extend(c[1:] if c[0] == op else (c,))
        uniq = sorted(set(terms), key=repr)
        if len(uniq) == 1:
            return uniq[0]
        return (op,) + tuple(uniq)
    raise ValueError(f"unknown predicate op {op!r} in {pred!r}")


def predicate_signature(pred) -> Optional[PredicateAST]:
    """Stable signature of a predicate: ``()`` for none, the canonical AST
    for a structured predicate, None for an opaque callable (uncacheable)."""
    if pred is None:
        return ()
    if isinstance(pred, tuple):
        return canonicalize_predicate(pred)
    return None


_CMP = {"<": torch.lt, "<=": torch.le, "==": torch.eq, "!=": torch.ne}


def compile_predicate(ast: PredicateAST) -> Callable:
    """Compile a (canonical or raw) predicate AST to a row filter ``f(values
    (N, c)) -> bool (N,)`` of torch ops on the values' device.  Comparisons
    run in the column's dtype (a literal is rounded to it, as numpy's weak
    scalars are), so the indicator equals the reference's."""
    ast = canonicalize_predicate(ast)

    def ev(node, vals):
        op = node[0]
        if op == "lit":
            # A 0-d tensor of the column's dtype: broadcasts, no (N,) copy.
            return torch.tensor(node[1], dtype=vals.dtype, device=vals.device)
        if op == "col":
            return vals[:, node[1]]
        if op == "not":
            return torch.logical_not(ev(node[1], vals))
        if op in _CMP_OPS:
            return _CMP[op](ev(node[1], vals), ev(node[2], vals))
        fold = torch.logical_and if op == "and" else torch.logical_or
        out = ev(node[1], vals)
        for t in node[2:]:
            out = fold(out, ev(t, vals))
        return out

    def run(vals: torch.Tensor) -> torch.Tensor:
        if vals.dim() == 1:
            vals = vals[:, None]
        return ev(ast, vals).expand(vals.shape[0])

    return run


# -- cache signature ---------------------------------------------------------
EPS_BUCKET_RATIO = 1.25


def epsilon_bucket(eps: float, ratio: float = EPS_BUCKET_RATIO) -> int:
    """Geometric bucket index of an error bound: eps in [r^k, r^(k+1)).

    Near-repeats share a warm-cache entry through the bucket: the fitted
    log-log coefficients are epsilon-independent, so any entry of the same
    query shape is a usable prior; the bucket bounds how far a lookup
    generalizes.  The 1e-9 nudge keeps values on a bucket edge (0.25 with
    ratio 1.25) stable under float noise.
    """
    if not eps > 0:
        raise ValueError(f"epsilon must be positive; got {eps!r}")
    return int(math.floor(math.log(eps) / math.log(ratio) + 1e-9))


def cache_signature(query: "Query", *, dataset_epoch: int = 0,
                    num_groups: Optional[int] = None
                    ) -> Optional[Tuple[Tuple, int]]:
    """``(shape, epsilon_bucket)`` identity of a query for the warm cache.

    ``shape`` is the epsilon-free part -- (dataset epoch, func, predicate
    signature, delta, metric, lp, bound kind) -- so a lookup can fall back to
    another bucket of the same shape.  None for an opaque callable
    predicate (uncacheable).  A GROUP BY query carries ``("groupby", G)`` in
    its shape, so its per-group entry never meets the solo entry of the same
    clause; ``num_groups`` is required for it.
    """
    pred_sig = predicate_signature(query.predicate)
    if pred_sig is None:
        return None
    if query.metric == "order":
        eps, kind = 1.0, "order"
    elif query.epsilon is not None:
        eps, kind = float(query.epsilon), "abs"
    else:
        eps, kind = float(query.epsilon_rel), "rel"
    shape = (int(dataset_epoch), query.func, pred_sig, float(query.delta),
             query.metric, None if query.lp is None else float(query.lp),
             kind)
    if query.group_by:
        if num_groups is None:
            raise ValueError(
                "grouped cache signatures need the dataset's num_groups")
        shape = shape + (("groupby", int(num_groups)),)
    return shape, epsilon_bucket(eps)


@dataclasses.dataclass(frozen=True)
class Query:
    func: str                              # estimator name (core.estimators)
    epsilon: Optional[float] = None        # absolute bound
    epsilon_rel: Optional[float] = None    # relative bound (vs pilot |theta|)
    delta: float = 0.05
    metric: str = "l2"
    predicate: Optional[Predicate] = None  # row predicate: callable | AST
    lp: Optional[float] = None             # the p of metric="lp" (p >= 1)
    group_by: bool = False                 # one answer PER GROUP

    def __post_init__(self):
        if self.metric not in METRICS:
            raise ValueError(f"metric {self.metric!r} not in {METRICS}")
        if isinstance(self.predicate, tuple):
            canonicalize_predicate(self.predicate)   # validate eagerly
        if self.metric == "lp":
            if self.lp is None or self.lp < 1:
                raise ValueError(
                    f"metric='lp' requires lp >= 1; got {self.lp!r}")
        elif self.lp is not None:
            raise ValueError(
                f"lp={self.lp!r} only applies to metric='lp' "
                f"(got metric {self.metric!r})")
        if self.metric != "order" and (self.epsilon is None) == (
                self.epsilon_rel is None):
            raise ValueError("exactly one of epsilon / epsilon_rel required")


_RID = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: a Listing-1 query plus its SLO envelope.

    ``deadline_s`` is the latency budget in seconds from submission (used
    for admission order and reported as ``slo_met``), ``priority`` breaks
    ties first (higher first), ``tenant`` names the traffic class, ``rid`` is
    a process-unique id assigned at construction.
    """
    query: Query
    deadline_s: Optional[float] = None
    priority: int = 0
    tenant: str = ""
    rid: int = dataclasses.field(default_factory=lambda: next(_RID))

    def __post_init__(self):
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(
                f"deadline_s must be positive; got {self.deadline_s!r}")
