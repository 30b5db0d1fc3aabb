"""Bootstrap error estimation (paper SS4.2).

Two ESTIMATEs live here:

* the generic one of the host route (:func:`estimate_error`): every group
  is resampled with its own key -- ``poisson`` weights (``mask *
  Poisson(1)`` from ``uniform(key, (B, n))``, the reference's draws),
  ``multinomial`` counts, or the CLT ``normal`` replicates of NormalMiss --
  and any estimator applies its weighted function to all B weight rows at
  once; the moment family takes a ``(B, n) @ (n, 3)`` product instead.
  Each group materializes its ``(B, n_cap)`` weights (79 MB of f32 at B =
  300, n_cap = 65 536) one group at a time;
* the moments path of the fused loop: every moment estimator finishes from
  the same replicate moment sums ``[sum w, sum w x, sum w x^2]`` under the
  counter-PRNG Poisson weights, so one pass of the bootstrap kernel serves
  a lane of any of them: moment sums -> dead-replicate guard -> finish ->
  per-group error -> joint metric -> per-lane (1 - delta) quantile.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import prng
from ..kernels.poisson_bootstrap import ops as pb_ops
from ..kernels.poisson_bootstrap import ref as pb_ref
from ..kernels.segment_agg import ops as seg_ops
from ..kernels.segment_agg import ref as seg_ref
from . import keys as keylib
from .estimators import Estimator, finish_by_family
from .reduce import tree_sum


def _joint_metric(per_group_err: torch.Tensor, metric: str,
                  axis: int = 0) -> torch.Tensor:
    """Combine per-group scalar errors into the joint metric along ``axis``."""
    if metric == "l2":
        return torch.sqrt(tree_sum(per_group_err * per_group_err, axis))
    if metric == "linf":
        return torch.amax(per_group_err, dim=axis)
    if metric == "l1":
        return tree_sum(per_group_err, axis)
    raise ValueError(f"unknown metric {metric!r}")


def quantile_linear(a: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Row-wise linear-interpolation quantile: row i of ``a (r, n)`` at
    ``q[i]``.  The formula of ``jnp.quantile`` (and ``torch.quantile``'s
    default ``interpolation="linear"``), with a quantile per row."""
    n = a.shape[-1]
    srt = torch.sort(a, dim=-1).values
    pos = q.to(torch.float32) * float(n - 1)
    low = torch.floor(pos)
    high = torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    lo_i = low.clamp(0, n - 1).to(torch.int64)[:, None]
    hi_i = high.clamp(0, n - 1).to(torch.int64)[:, None]
    return (torch.gather(srt, -1, lo_i)[:, 0] * lw
            + torch.gather(srt, -1, hi_i)[:, 0] * hw)


def poisson_weights(key, B: int, n: int, device) -> torch.Tensor:
    """(B, n) iid Poisson(1) resample counts: the inverse-CDF ladder on
    ``uniform(key, (B, n))``."""
    return prng.poisson1_from_uniform(keylib.uniform(key, (B, n),
                                                     device=device))


def multinomial_weights(key, B: int, mask: torch.Tensor) -> torch.Tensor:
    """(B, n) exact multinomial resample counts over the valid rows: each
    of the n_valid draws is an inverse-CDF search of ``uniform(key, (B,
    n))`` over the cumulative mask; padding draws are dropped."""
    n = mask.shape[0]
    w = mask.to(torch.float32)
    cdf = torch.cumsum(w, 0) / torch.clamp(torch.sum(w), min=1e-9)
    u = keylib.uniform(key, (B, n), device=mask.device)
    idx = torch.clamp(torch.searchsorted(cdf, u, right=True), 0, n - 1)
    n_valid = torch.sum(mask)
    keep = (torch.arange(n, device=mask.device)[None, :] < n_valid).expand(
        B, n).to(torch.float32)
    counts = torch.zeros((B, n), dtype=torch.float32, device=mask.device)
    counts.scatter_add_(1, idx, keep)
    return counts * w[None, :]


def _weights(x: torch.Tensor, mask: torch.Tensor, key, B: int,
             backend: str) -> torch.Tensor:
    if backend == "poisson":
        w = poisson_weights(key, B, x.shape[0], x.device) * mask[None, :]
        # An all-zero draw on a tiny sample falls back to the mask (the
        # identity replicate).
        dead = torch.sum(w, 1, keepdim=True) <= 0
        return torch.where(dead, mask[None, :].to(w.dtype), w)
    if backend == "multinomial":
        return multinomial_weights(key, B, mask)
    raise ValueError(f"unknown bootstrap backend {backend!r}")


# Estimators whose CLT standard error NormalMiss computes in closed form.
_NORMAL_OK = ("avg", "proportion", "sum", "count", "var", "std")


def normal_replicates(est: Estimator, x: torch.Tensor, mask: torch.Tensor,
                      key, B: int) -> torch.Tensor:
    """NormalMiss backend (paper SS6.2): CLT Gaussian replicates
    ``theta* ~ N(theta_hat, avar / n)`` -- no resampling, B cheap draws."""
    if est.name not in _NORMAL_OK:
        raise ValueError(f"normal backend unsupported for {est.name}")
    v = (x[:, 0] if x.dim() == 2 else x).to(torch.float32)
    w = mask.to(torch.float32)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(w * v) / n
    d2 = (v - mean) * (v - mean)
    var = torch.sum(w * d2) / n
    if est.name in ("var", "std"):
        mu4 = torch.sum(w * (d2 * d2)) / n
        avar = torch.clamp(mu4 - var * var, min=1e-12)
        if est.name == "var":
            theta = var
        else:
            theta = torch.sqrt(torch.clamp(var, min=1e-12))
            avar = avar / (4 * var)
    else:
        theta, avar = mean, var
    se = torch.sqrt(avar / n)
    z = keylib.normal(key, (B, 1), device=x.device)
    return theta + se * z


def replicates(est: Estimator, x: torch.Tensor, mask: torch.Tensor, key,
               B: int, backend: str = "poisson") -> torch.Tensor:
    """(B, p) bootstrap replicates of f on one group's sample.  Moment
    estimators take one (B, n) @ (n, 3) product over [1, x, x^2]."""
    if backend == "normal":
        return normal_replicates(est, x, mask, key, B)
    w = _weights(x, mask, key, B, backend)
    if est.moments_finish is not None:
        v = (x[:, 0] if x.dim() == 2 else x).to(torch.float32)
        feats = torch.stack([torch.ones_like(v), v, v * v], dim=1)
        return est.moments_finish(w @ feats)
    return est.apply(est.prepare(x), w)


def _group_replicates(est, sample, mask, key, B, backend):
    """(theta_hat (m, p), reps (m, B, p)), group g under ``split(key,
    m)[g]``."""
    keys = keylib.split(key, sample.shape[0])
    thetas, reps = [], []
    for xg, mg, kg in zip(sample, mask, keys):
        thetas.append(est.apply(est.prepare(xg), mg.to(torch.float32)))
        reps.append(replicates(est, xg, mg, kg, B, backend))
    return torch.stack(thetas), torch.stack(reps)


def one_minus(delta) -> float:
    """``1 - delta`` in f32, as the reference's traced ESTIMATE forms it."""
    return float(np.float32(1.0) - np.float32(delta))


def _quantile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a, q)`` (linear) of a 1-D tensor."""
    return quantile_linear(a[None, :], torch.full(
        (1,), q, dtype=torch.float32, device=a.device))[0]


def estimate_error(est: Estimator, sample: torch.Tensor, mask: torch.Tensor,
                   scale: torch.Tensor, key, delta: float, B: int = 500,
                   backend: str = "poisson", metric: str = "l2"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The host route's generic ESTIMATE: ``(e, theta_hat (m, p))`` for the
    joint metric across the m groups of ``sample (m, n_cap, c)``.

    ``e`` is the (1 - delta) quantile of the joint metric of the per-group
    errors, each group resampled independently; a multi-output estimator
    (a regression) contributes the L2 norm of its coefficient error.
    """
    theta_hat, reps = _group_replicates(est, sample, mask, key, B, backend)
    dev = reps - theta_hat[:, None, :]                         # (m, B, p)
    per_group_err = torch.sqrt(torch.sum(dev * dev, -1)) * scale[:, None]
    joint = _joint_metric(per_group_err, metric, axis=0)       # (B,)
    e = _quantile(joint, one_minus(delta))
    return e, theta_hat * scale[:, None]


def per_group_errors(est: Estimator, sample: torch.Tensor,
                     mask: torch.Tensor, scale: torch.Tensor, key,
                     delta: float, B: int = 500,
                     backend: str = "poisson") -> torch.Tensor:
    """(m,) per-group (1 - delta)-quantile errors (BLK-style baselines)."""
    theta_hat, reps = _group_replicates(est, sample, mask, key, B, backend)
    dev = reps - theta_hat[:, None, :]
    err = torch.sqrt(torch.sum(dev * dev, -1))                 # (m, B)
    q = float(np.float32(1.0 - delta))
    return torch.stack([_quantile(eg, q) for eg in err]) * scale


def lane_moment_sums(v: torch.Tensor, mf: torch.Tensor, seeds: torch.Tensor,
                     B: int, *, use_kernel: bool,
                     lane_active: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RAW (unguarded) replicate moment sums of ``q`` lanes of ``m`` groups.

    ``(M (q, m, B, 3), M_plain (q, m, 3))``: row b of M is ``[sum w, sum w x,
    sum w x^2]`` under weight ``poisson1(hash3(seeds[i, g], j, b))`` (j the
    absolute slot), M_plain the mask-only sums.  ``lane_active (q,)`` skips
    inactive lanes entirely (zeros come back); callers pass it only when
    they discard those lanes' outputs.  ``use_kernel`` launches the CUDA
    kernel (CUDA tensors); otherwise the plain version runs.  Both sum in the
    same fixed order, so they agree bit for bit, and both are invariant to
    zero-mask slots appended to the slice (the width-bucket invariance).
    """
    q, m, w = mf.shape
    feats = torch.stack([mf, mf * v, mf * v * v], dim=-1)      # (q, m, w, 3)
    M_plain = tree_sum(feats, 2)                               # (q, m, 3)
    act = None if lane_active is None else lane_active[:, None].expand(q, m)
    if use_kernel:
        if v.stride(-1) != 1:
            v = v.contiguous()
        M = pb_ops.bootstrap_moments_masked(v, mf, seeds, B,
                                            lane_active=act)[..., :3]
    else:
        M = pb_ref.bootstrap_moments_masked_ref(v, mf, seeds, B,
                                                lane_active=act)[..., :3]
    return M, M_plain


def _window_feats(vals: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  lane_active: torch.Tensor):
    """``(mf, vz, M_plain)`` of live windows: ``mf (q, m, cap)`` the mask of
    ``[lo, hi)`` on active lanes, ``vz`` the values with every other slot an
    exact +0 (whatever the buffer holds there), ``M_plain (q, m, 3)`` the
    mask-only sums over the whole slot axis (:func:`tree_sum`, so they do not
    depend on how wide a slice the replicate sums read)."""
    cap = vals.shape[-1]
    pos = torch.arange(cap, dtype=torch.int64, device=vals.device)
    live = ((pos >= lo[..., None]) & (pos < hi[..., None])
            & lane_active.to(torch.bool)[:, None, None])
    mf = live.to(torch.float32).contiguous()
    vz = torch.where(live, vals.to(torch.float32), 0.0).contiguous()
    feats = torch.stack([mf, mf * vz, mf * vz * vz], dim=-1)
    return mf, vz, tree_sum(feats, 2)


def windowed_lane_moment_sums(vals: torch.Tensor, lo: torch.Tensor,
                              hi: torch.Tensor, seeds: torch.Tensor, B: int,
                              widths, *, lane_active: torch.Tensor,
                              chunk: int = 4
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RAW replicate moment sums over per-lane WINDOWS: the plain path of the
    sharded step's ESTIMATE.

    ``vals (q, m, cap)`` is one shard segment's value column, ``lo``/``hi
    (q, m)`` each (lane, group)'s live window in segment slots, ``widths`` the
    reference's ascending rung ladder topped by ``cap``.  Returns ``(M (q, m,
    B, 3), M_plain (q, m, 3))`` as :func:`lane_moment_sums` does, inactive
    lanes exact zeros.  Lanes go in chunks of ``chunk``: an all-parked chunk
    does no work.  A live chunk sums its lanes' windows at their ABSOLUTE
    slot positions through the plain version of the Poisson-bootstrap
    kernel, over the slice from the 256-slot chunk boundary below its lowest
    window to its highest window end: the kernel's order, so the sums equal
    :func:`prefix_lane_moment_sums` (the card's path) bit for bit.  The
    reference instead re-bases each window into a rung-wide gathered slice,
    which reorders the additions; the port sizes the slice from the windows
    (one host read a call), so ``widths`` is checked, not used.  Slots
    outside a window contribute an exact zero whatever the buffer holds.
    """
    q, m, cap = vals.shape
    if widths[-1] != cap:
        raise ValueError(f"width ladder {widths} must top out at cap={cap}")
    c = max(1, min(int(chunk), q))
    mf, vz, M_plain = _window_feats(vals, lo, hi, lane_active)
    M = torch.zeros((q, m, B, 3), dtype=torch.float32, device=vals.device)
    host = torch.cat([lane_active.to(torch.int64).reshape(-1),
                      lo.to(torch.int64).reshape(-1),
                      hi.to(torch.int64).reshape(-1)]).cpu().numpy()
    act = host[:q] != 0
    lo_h = host[q:q + q * m].reshape(q, m)
    hi_h = host[q + q * m:].reshape(q, m)
    for c0 in range(0, q, c):
        sel = np.arange(c0, min(c0 + c, q))
        live = act[sel][:, None] & (hi_h[sel] > lo_h[sel])
        if not live.any():
            continue
        start = int(lo_h[sel][live].min()) // pb_ref.CHUNK * pb_ref.CHUNK
        end = int(hi_h[sel][live].max())
        gate = lane_active[c0:c0 + len(sel), None].expand(len(sel), m)
        M[c0:c0 + len(sel)] = pb_ref.bootstrap_moments_masked_ref(
            vz[c0:c0 + len(sel), :, start:end],
            mf[c0:c0 + len(sel), :, start:end], seeds[c0:c0 + len(sel)], B,
            lane_active=gate, start=start)[..., :3]
    return M, M_plain


def prefix_lane_moment_sums(vals: torch.Tensor, lo: torch.Tensor,
                            hi: torch.Tensor, seeds: torch.Tensor, B: int,
                            width: int, *, lane_active: torch.Tensor,
                            use_kernel: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sums of :func:`windowed_lane_moment_sums` from ONE shared prefix
    rung: the window is a mask on ``vals[..., :width]`` (``width`` covering
    every active window) and the replicate sums come from
    :func:`lane_moment_sums` -- on the card one Poisson-bootstrap kernel
    launch, the reference's ``use_kernel`` branch."""
    mf, vz, M_plain = _window_feats(vals, lo, hi, lane_active)
    M, _ = lane_moment_sums(vz[..., :width], mf[..., :width], seeds, B,
                            use_kernel=use_kernel, lane_active=lane_active)
    return M, M_plain


def segment_moment_sums(x: torch.Tensor, gid: torch.Tensor,
                        slot: torch.Tensor, valid: torch.Tensor,
                        seeds: torch.Tensor, q: int, B: int, *,
                        use_kernel: bool, n_slots: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RAW replicate moment sums over one PACKED stream of lane windows (the
    grouped block's ESTIMATE).

    ``x (L,)`` are the gathered values of the active lanes' windows
    concatenated in lane order, slots ascending within a lane; ``gid (L,)``
    the owning lane, ``slot (L,)`` each element's absolute buffer slot (all
    below ``n_slots``), ``valid (L,)`` the stream's mask, ``seeds (q,)`` the
    lanes' tick seeds.  Returns ``(M (q, B, 3), M_plain (q, 3))``, weight
    (j, b) = ``poisson1(hash3(seeds[gid_j], slot_j, b))`` -- the draw
    :func:`lane_moment_sums` makes for that (lane, slot, replicate).

    Both sums take the solo path's order: M chunks each lane by absolute
    slot as the Poisson-bootstrap kernel does, and M_plain is the lane's
    :func:`tree_sum` over its slot axis, so a block lane's sums equal its
    solo run's bit for bit.  ``use_kernel`` launches the segment kernel
    (CUDA tensors); otherwise the plain version runs.
    """
    mf = valid.to(torch.float32)
    xf = x.to(torch.float32)
    gid = gid.to(torch.int64)
    slot = slot.to(torch.int64)
    feats = torch.stack([mf, mf * xf, mf * xf * xf], dim=-1)   # (L, 3)
    dense = torch.zeros((q, max(int(n_slots), 1), 3), dtype=torch.float32,
                        device=xf.device)
    # Each (lane, slot) is one element of the stream, so the accumulating
    # put only ever adds to an exact zero.
    dense.index_put_((gid, slot), feats, accumulate=True)
    M_plain = tree_sum(dense, 1)                               # (q, 3)
    lane_off = torch.searchsorted(
        gid, torch.arange(q + 1, dtype=torch.int64, device=gid.device))
    seed_j = seeds.to(torch.int64)[gid]
    boot = (seg_ops.segment_bootstrap_sorted if use_kernel
            else seg_ref.segment_bootstrap_sorted_ref)
    M = boot(xf, mf, slot, seed_j, lane_off, B, n_slots)
    return M, M_plain


def guard_dead_replicates(M: torch.Tensor, M_plain: torch.Tensor
                          ) -> torch.Tensor:
    """Substitute the plain sample for dead replicates (``sum w == 0``)."""
    dead = M[..., 0:1] <= 0
    return torch.where(dead, M_plain[:, :, None, :], M)


def finish_lanes_moments(M: torch.Tensor, M_plain: torch.Tensor,
                         scale: torch.Tensor, deltas: torch.Tensor,
                         est: Optional[Estimator] = None,
                         est_fids: Optional[torch.Tensor] = None,
                         metric: str = "l2"
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(e (q,), theta (q, m, 1)) from replicate moment sums: guard dead
    replicates, finish (one estimator, or per lane by family index), then
    per-group errors -> joint metric -> per-lane (1 - delta) quantile."""
    M = guard_dead_replicates(M, M_plain)
    Mp = M_plain[:, :, None, :]
    if est is not None:
        reps = est.moments_finish(M)                           # (q, m, B, 1)
        theta = est.moments_finish(Mp)[:, :, 0, :]
    else:
        reps = finish_by_family(est_fids, M)
        theta = finish_by_family(est_fids, Mp)[:, :, 0, :]
    dev = reps - theta[:, :, None, :]                          # (q, m, B, 1)
    per_group_err = torch.sqrt(tree_sum(dev * dev, -1)) * scale[..., None]
    joint = _joint_metric(per_group_err, metric, axis=1)       # (q, B)
    e = quantile_linear(joint, 1.0 - deltas)
    return e, theta * scale[..., None]


def estimate_error_lanes(est: Estimator, sample: torch.Tensor,
                         mask: torch.Tensor, seeds: torch.Tensor,
                         scale: torch.Tensor, deltas: torch.Tensor,
                         B: int = 500, metric: str = "l2",
                         use_kernel: bool = False,
                         lane_active: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lane-batched ESTIMATE for one moment estimator on a width-bucketed
    slice ``sample (q, m, w[, c])`` / ``mask (q, m, w)`` of the carried
    buffer; invariant to the width ``w``."""
    v = (sample[..., 0] if sample.dim() == 4 else sample).to(torch.float32)
    M, M_plain = lane_moment_sums(v, mask.to(torch.float32), seeds, B,
                                  use_kernel=use_kernel,
                                  lane_active=lane_active)
    return finish_lanes_moments(M, M_plain, scale, deltas, est=est,
                                metric=metric)


def estimate_error_lanes_het(sample: torch.Tensor, mask: torch.Tensor,
                             seeds: torch.Tensor, est_fids: torch.Tensor,
                             scale: torch.Tensor, deltas: torch.Tensor,
                             B: int = 500, metric: str = "l2",
                             use_kernel: bool = False,
                             lane_active: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Heterogeneous-lane ESTIMATE: lane i finishes through moment-family
    branch ``est_fids[i]``; the moment pass is shared, so a lane's (e,
    theta) equals the homogeneous :func:`estimate_error_lanes` for its
    estimator."""
    v = (sample[..., 0] if sample.dim() == 4 else sample).to(torch.float32)
    M, M_plain = lane_moment_sums(v, mask.to(torch.float32), seeds, B,
                                  use_kernel=use_kernel,
                                  lane_active=lane_active)
    return finish_lanes_moments(M, M_plain, scale, deltas, est_fids=est_fids,
                                metric=metric)
