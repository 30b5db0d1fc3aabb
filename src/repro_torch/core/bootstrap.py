"""Bootstrap error estimation (paper SS4.2): the moments path of the fused
loop's ESTIMATE.

Every moment estimator (avg/proportion/var/std/sum/count) finishes from the
same replicate moment sums ``[sum w, sum w x, sum w x^2]`` under the counter
PRNG Poisson weights, so one pass of the bootstrap kernel serves a lane of
any of them, and the ESTIMATE is: moment sums -> dead-replicate guard ->
finish -> per-group error -> joint metric -> per-lane (1 - delta) quantile.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.poisson_bootstrap import ops as pb_ops
from ..kernels.poisson_bootstrap import ref as pb_ref
from ..kernels.segment_agg import ops as seg_ops
from ..kernels.segment_agg import ref as seg_ref
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
