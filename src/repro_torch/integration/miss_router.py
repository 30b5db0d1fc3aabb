"""MISS-certified MoE router load estimation.

Expert-parallel rebalancing (capacity factors, expert replication) needs
per-expert load fractions over the token stream.  Exact counting costs a
full pass; the load vector is a single-group VECTOR-valued PROPORTION query
-- each bootstrap replicate reweights the sampled tokens' one-hot expert
choices -- so MISS finds the minimal token sample certifying
||load_hat - load||_2 <= eps at 1-delta.  The route function and token
source are the caller's (host numpy); the one-hot pool goes to the device
(the card by default) for each ESTIMATE.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core import bootstrap as bs
from ..core import keys as keylib
from ..core.estimators import Estimator
from ..core.framework import run_miss
from ..core.sampling import default_device, root_key, two_point_init_sizes
from .miss_eval import next_sizes


def _colmean_estimator(E: int) -> Estimator:
    """Vector estimator: per-column weighted mean of (n, E) indicators,
    for a weight vector ``(n,)`` or a batch of them ``(..., n)``."""

    def prepare(x):
        return x                                   # (n, E)

    def apply(aux, w):
        tot = torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
        return (w @ aux) / tot                     # (..., E)

    return Estimator("colmean", prepare, apply, lambda c: E)


@dataclasses.dataclass
class RouterLoadResult:
    load: np.ndarray          # (E,) certified load fractions
    n_tokens: int             # tokens routed to certify
    iterations: int
    error: float
    success: bool


def estimate_router_load(
    route_fn: Callable[[np.ndarray], np.ndarray],
    token_source: Callable[[int], np.ndarray],
    num_experts: int,
    *,
    epsilon: float = 0.01,
    delta: float = 0.05,
    B: int = 200,
    n_min: int = 256,
    n_max: int = 512,
    max_iters: int = 16,
    seed: int = 0,
    device=None,
) -> RouterLoadResult:
    """route_fn(tokens (n, S)) -> (n*S*top_k,) expert indices (flattened);
    token_source(n) -> (n, S) fresh token batch."""
    dev = torch.device(device) if device is not None else default_device()
    est = _colmean_estimator(num_experts)
    key = root_key(seed)
    state = {"onehots": np.zeros((0, num_experts), np.float32), "tokens": 0}

    class Subs:
        def initialize(self):
            nonlocal key
            key, sub = keylib.split(key)
            return two_point_init_sizes(sub, 1, 4, n_min, n_max)

        def sample(self, n_vec, it):
            need = int(n_vec[0]) - len(state["onehots"])
            if need > 0:
                toks = token_source(need)
                idx = np.asarray(route_fn(toks)).reshape(-1)
                oh = np.zeros((len(idx), num_experts), np.float32)
                oh[np.arange(len(idx)), idx] = 1.0
                # aggregate per token-batch row into one routing sample each
                oh = oh.reshape(need, -1, num_experts).mean(axis=1)
                state["onehots"] = np.concatenate([state["onehots"], oh])
                state["tokens"] += need
            return n_vec

        def estimate(self, n_vec, it):
            nonlocal key
            n = int(n_vec[0])
            x = torch.as_tensor(state["onehots"][:n][None], device=dev)
            mask = torch.ones((1, n), dtype=torch.float32, device=dev)
            key, sub = keylib.split(key)
            e, theta = bs.estimate_error(
                est, x, mask, torch.ones((1,), dtype=torch.float32,
                                         device=dev), sub, delta, B=B)
            return float(e), theta.cpu().numpy()

        _prev = None

        def predict(self, profile_n, profile_e, it):
            prev = self._prev if self._prev is not None else \
                profile_n.max(axis=0).astype(np.int64)
            n_next, fit = next_sizes(profile_n, profile_e, epsilon, 1e-3,
                                     prev, 8, dev, "router load error")
            self._prev = n_next
            return n_next, {"r2": float(fit.r2)}

    trace = run_miss(Subs(), epsilon, max_iters=max_iters)
    return RouterLoadResult(
        load=trace.theta[0] if trace.theta is not None else None,
        n_tokens=state["tokens"],
        iterations=trace.iterations,
        error=trace.error,
        success=trace.success,
    )
