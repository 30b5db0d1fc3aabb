"""The linear error model H(n; beta) = beta0 - sum_i beta_i log n_i (paper
SS2.2): WLS fit (Eq. 11), failure diagnostic (Alg. 2) and the closed-form
prediction of the optimal sample size (Eq. 13).

Every function takes leading batch dimensions (one row per lane) and uses
only elementwise ops, fixed-order sums (:func:`~.reduce.tree_sum`) and a
hand-written pivoted elimination for the (m+1)-sized solve, so the CPU and
the card run the same f32 arithmetic: ``ceil(n_hat)`` turns a one-ulp
difference in the solve into a different sample size.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .reduce import tree_sum

DIAG_OK = 0
DIAG_RECOVERED = 1      # some beta_i <= 0 -> equalized (recoverable failure)
DIAG_FAILURE = 2        # sum beta_i <= tau -> unrecoverable


class ErrorModelFit(NamedTuple):
    beta: torch.Tensor     # (..., m + 1): [beta0, beta_1..beta_m]
    r2: torch.Tensor       # (...,) goodness of fit on the weighted profile
    status: torch.Tensor   # (...,) int32 diagnostic code


def design_row(n_vec: torch.Tensor) -> torch.Tensor:
    """n-tilde = (1, -log n_1, ..., -log n_m)."""
    logn = -torch.log(n_vec.to(torch.float32))
    return torch.cat([torch.ones_like(logn[..., :1]), logn], dim=-1)


def solve(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``G x = b`` by Gaussian elimination with partial pivoting.

    ``G (..., n, n)``, ``b (..., n)``; n is the tiny model order, so the
    Python loop over columns costs a few elementwise ops each.
    """
    n = G.shape[-1]
    aug = torch.cat([G, b[..., None]], dim=-1)               # (..., n, n+1)
    rows = torch.arange(n, device=G.device)
    for k in range(n):
        col = aug[..., k:, k].abs()
        p = torch.argmax(col, dim=-1) + k                     # (...,)
        perm = rows.expand(aug.shape[:-1]).clone()
        perm[..., k] = p
        perm.scatter_(-1, p[..., None], k)
        aug = torch.gather(aug, -2, perm[..., None].expand(aug.shape))
        factor = aug[..., k + 1:, k:k + 1] / aug[..., k:k + 1, k:k + 1]
        aug = torch.cat([aug[..., :k + 1, :],
                         aug[..., k + 1:, :] - factor * aug[..., k:k + 1, :]],
                        dim=-2)
    x = [None] * n
    for k in range(n - 1, -1, -1):
        acc = aug[..., k, n]
        for j in range(k + 1, n):
            acc = acc - aug[..., k, j] * x[j]
        x[k] = acc / aug[..., k, k]
    return torch.stack(x, dim=-1)


def fit_wls(profile_n: torch.Tensor, profile_loge: torch.Tensor,
            row_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted least squares fit of H (Eq. 11), w_k = total sample size.

    ``profile_n (..., k, m)``, ``profile_loge (..., k)``, ``row_valid
    (..., k)`` (0 for padding rows).  Returns ``(beta (..., m+1), r2)``.
    """
    m = profile_n.shape[-1]
    N = design_row(profile_n)                                 # (..., k, m+1)
    w = tree_sum(profile_n.to(torch.float32), -1) * row_valid  # (..., k)
    sw = torch.sqrt(w)
    A = N * sw[..., None]
    y = profile_loge * sw
    # Ridge-stabilized normal equations (k can be < m+1 early on).
    G = tree_sum(A[..., :, :, None] * A[..., :, None, :], -3)
    G = G + 1e-8 * torch.eye(m + 1, dtype=torch.float32, device=G.device)
    beta = solve(G, tree_sum(A * y[..., None], -2))
    resid = (tree_sum(N * beta[..., None, :], -1) - profile_loge) * sw
    mean_y = tree_sum(w * profile_loge, -1) / torch.clamp(
        tree_sum(w, -1), min=1e-12)
    ss_res = tree_sum(resid * resid, -1)
    dev = profile_loge - mean_y[..., None]
    ss_tot = tree_sum(w * (dev * dev), -1)
    r2 = 1.0 - ss_res / torch.clamp(ss_tot, min=1e-12)
    return beta, r2


def diagnose(beta: torch.Tensor, tau: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 2.  Returns (calibrated beta, status code).

    Unrecoverable: sum_i beta_i <= tau.  Recoverable: min_i beta_i <= 0 ->
    equalize the slopes to their mean.
    """
    slopes = beta[..., 1:]
    total = tree_sum(slopes, -1)
    unrecoverable = total <= tau
    recoverable = torch.amin(slopes, dim=-1) <= 0.0
    mean_slope = total / slopes.shape[-1]
    slopes_fixed = torch.where(recoverable[..., None],
                               mean_slope[..., None].expand_as(slopes), slopes)
    beta_out = torch.cat([beta[..., :1], slopes_fixed], dim=-1)
    status = torch.where(
        unrecoverable, DIAG_FAILURE,
        torch.where(recoverable, DIAG_RECOVERED, DIAG_OK)).to(torch.int32)
    return beta_out, status


def predict_optimal_n(beta: torch.Tensor, log_eps: torch.Tensor,
                      cost_weights: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Closed-form min c'n s.t. H(n; beta) <= log eps.

    Uniform cost (Eq. 13): n_i = beta_i * exp((beta0 - sum_j beta_j log
    beta_j - log eps) / sum_j beta_j).  Linear cost ``c`` (paper SS8):
    n_i = lambda beta_i / c_i with log lambda = (beta0 - sum_j beta_j
    log(beta_j / c_j) - log eps) / sum_j beta_j.  Assumes positive slopes
    (guaranteed post-diagnose unless FAILURE)."""
    b0 = beta[..., 0]
    b = torch.clamp(beta[..., 1:], min=1e-9)
    s = tree_sum(b, -1)
    ratio = b if cost_weights is None else b / torch.clamp(cost_weights,
                                                           min=1e-12)
    log_lambda = (b0 - tree_sum(b * torch.log(ratio), -1) - log_eps) / s
    return ratio * torch.exp(log_lambda)[..., None]


def model_value(beta: torch.Tensor, n_vec: torch.Tensor) -> torch.Tensor:
    """H(n; beta) = beta0 - sum_i beta_i log n_i (predicted log error)."""
    return beta[..., 0] - tree_sum(beta[..., 1:] * torch.log(
        n_vec.to(torch.float32)), -1)


def fit_and_predict(profile_n: torch.Tensor, profile_loge: torch.Tensor,
                    row_valid: torch.Tensor, log_eps: torch.Tensor,
                    tau: float, cost_weights: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, ErrorModelFit]:
    """Fused PREDICT subroutine: fit -> diagnose -> closed-form optimum."""
    beta, r2 = fit_wls(profile_n, profile_loge, row_valid)
    beta_cal, status = diagnose(beta, tau)
    n_hat = predict_optimal_n(beta_cal, log_eps, cost_weights)
    return n_hat, ErrorModelFit(beta_cal, r2, status)
