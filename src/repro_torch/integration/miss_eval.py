"""MISS-certified approximate evaluation -- the paper's technique as a
first-class training-loop feature.

A production eval suite spans m domains x millions of held-out sequences.
The per-domain mean loss IS an m-group AVG query (paper Listing 1), so MISS
applies verbatim: find the minimal number of eval sequences per domain such
that the joint L2 error of the per-domain loss vector is <= eps with
confidence 1-delta.

The evaluator is lazy and incremental: per MISS iteration it runs the model
ONLY on newly requested examples (per-example losses are deterministic, so
previously evaluated examples are cached), then bootstrap-estimates the
error from the evaluated pool.  The savings vs full eval is exactly the
paper's total-sample-size story, with model-forward cost standing in for
row-scan cost.  The token sets and the model live on the evaluator's device
(the card by default); the loss cache and the MISS loop's bookkeeping are
host numpy, the ESTIMATE is the generic bootstrap on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..core import bootstrap, error_model
from ..core import keys as keylib
from ..core.estimators import get as get_est
from ..core.framework import MissFailure, MissTrace, run_miss
from ..core.sampling import default_device, root_key, two_point_init_sizes


@dataclasses.dataclass
class MissEvalConfig:
    epsilon: float                  # L2 bound on the per-domain loss vector
    delta: float = 0.05
    B: int = 200
    n_min: int = 32
    n_max: int = 64
    l: int = 6
    tau: float = 1e-3
    max_iters: int = 24
    growth_cap: float = 8.0
    eval_batch: int = 32            # model-forward microbatch
    seed: int = 0


def next_sizes(profile_n: np.ndarray, profile_e: np.ndarray, epsilon: float,
               tau: float, prev: np.ndarray, growth_cap: float, device,
               what: str) -> Tuple[np.ndarray, error_model.ErrorModelFit]:
    """PREDICT of the integration adapters: the Eq.-13 sizes of the fitted
    error model (f32 on ``device``), raised to at least the size the last
    error's ratio to epsilon asks under the fitted slope, at most
    ``prev * growth_cap + 1`` and at least ``prev + 1``.  Raises
    :class:`MissFailure` (``what`` does not shrink) on a failed fit."""
    f32 = dict(dtype=torch.float32, device=device)
    loge = np.log(np.maximum(profile_e, 1e-30))
    n_hat, fit = error_model.fit_and_predict(
        torch.as_tensor(profile_n, **f32), torch.as_tensor(loge, **f32),
        torch.ones((len(loge),), **f32),
        keylib.log_f32(torch.tensor(epsilon, **f32)), tau)
    if int(fit.status) == error_model.DIAG_FAILURE:
        raise MissFailure(f"{what} does not shrink with n")
    n_next = np.maximum(torch.ceil(n_hat).cpu().numpy().astype(np.int64), 1)
    slopes = fit.beta.cpu().numpy()[1:]
    s = max(float(slopes.sum()), 1e-3)
    ratio = float(profile_e[-1]) / epsilon
    if ratio > 1.0:
        n_next = np.maximum(n_next, np.ceil(
            profile_n[-1] * ratio ** (1.0 / s)).astype(np.int64))
    n_next = np.minimum(n_next, (prev * growth_cap).astype(np.int64) + 1)
    return np.maximum(n_next, prev + 1), fit


class MissEvaluator:
    """certify() returns a MissTrace whose theta is the certified per-domain
    loss vector and whose total_sampled counts model forwards saved."""

    def __init__(self, per_example_loss: Callable[[torch.Tensor], object],
                 domains: Sequence, cfg: MissEvalConfig, *, device=None):
        """per_example_loss(batch_tokens (b, S) on the evaluator's device)
        -> (b,) losses (a tensor or an array).  domains: list of (N_g, S)
        token tensors or arrays (held-out sets), kept on ``device`` (a
        tensor's own device, else the card)."""
        if device is None:
            device = (domains[0].device if isinstance(domains[0], torch.Tensor)
                      else default_device())
        self.device = torch.device(device)
        self.loss_fn = per_example_loss
        self.domains = [torch.as_tensor(d, device=self.device)
                        for d in domains]
        self.cfg = cfg
        self.m = len(domains)
        self._caps = np.asarray([len(d) for d in self.domains])
        rngs = np.random.default_rng(cfg.seed)
        # Random evaluation order per domain; prefix = evaluated pool.
        self._order = [rngs.permutation(len(d)) for d in self.domains]
        self._losses: List[np.ndarray] = [
            np.zeros((0,), np.float32) for _ in range(self.m)]
        self.model_forwards = 0
        self.key = root_key(cfg.seed)
        self._prev_n = None

    # -- incremental evaluation --------------------------------------------
    def _ensure(self, g: int, n: int):
        have = len(self._losses[g])
        n = min(n, len(self.domains[g]))
        if have >= n:
            return
        idx = torch.as_tensor(self._order[g][have:n], device=self.device)
        new = []
        bs = self.cfg.eval_batch
        for i in range(0, len(idx), bs):
            chunk = self.domains[g][idx[i:i + bs]]
            out = torch.as_tensor(self.loss_fn(chunk))
            new.append(out.detach().to(torch.float32).cpu().numpy())
            self.model_forwards += len(chunk)
        self._losses[g] = np.concatenate([self._losses[g]] + new)

    # -- MISS subroutines ----------------------------------------------------
    def initialize(self):
        self.key, sub = keylib.split(self.key)
        rows = two_point_init_sizes(sub, self.m, self.cfg.l, self.cfg.n_min,
                                    self.cfg.n_max)
        return np.minimum(rows, self._caps[None, :])

    def sample(self, n_vec, it):
        for g in range(self.m):
            self._ensure(g, int(n_vec[g]))
        return np.minimum(np.asarray(n_vec, np.int64), self._caps)

    def estimate(self, n_vec, it):
        cfg = self.cfg
        n_cap = int(max(n_vec))
        sample = np.zeros((self.m, n_cap, 1), np.float32)
        mask = np.zeros((self.m, n_cap), np.float32)
        for g in range(self.m):
            k = int(n_vec[g])
            sample[g, :k, 0] = self._losses[g][:k]
            mask[g, :k] = 1.0
        self.key, sub = keylib.split(self.key)
        dev = self.device
        e, theta = bootstrap.estimate_error(
            get_est("avg"), torch.as_tensor(sample, device=dev),
            torch.as_tensor(mask, device=dev),
            torch.ones((self.m,), dtype=torch.float32, device=dev), sub,
            cfg.delta, B=cfg.B)
        return float(e), theta.cpu().numpy()

    def predict(self, profile_n, profile_e, it):
        cfg = self.cfg
        prev = (self._prev_n if self._prev_n is not None
                else profile_n.max(axis=0).astype(np.int64))
        n_next, fit = next_sizes(profile_n, profile_e, cfg.epsilon, cfg.tau,
                                 prev, cfg.growth_cap, self.device,
                                 "eval loss error")
        n_next = np.minimum(n_next, self._caps)
        self._prev_n = n_next
        return n_next, {"beta": fit.beta.cpu().numpy(), "r2": float(fit.r2)}

    def certify(self) -> MissTrace:
        trace = run_miss(self, self.cfg.epsilon,
                         max_iters=self.cfg.max_iters)
        trace.info["model_forwards"] = self.model_forwards
        trace.info["full_eval_forwards"] = int(self._caps.sum())
        return trace
