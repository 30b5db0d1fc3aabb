"""Fused L2Miss: the MISS loop as a resumable per-lane step on the card.

The carried state is a :class:`LaneState` (one row per query lane) and one
SAMPLE -> ESTIMATE -> FIT -> PREDICT -> TEST tick over all lanes is
:func:`fused_step`; the closed loop :func:`fused_l2miss_lanes` ticks the
same body until every lane is done, so closed-loop and host-ticked
trajectories are identical by construction.

* The sample buffer ``(q, m, n_cap, c)`` is carried across ticks.  Slot j of
  group i is bound to a fixed row by the counter PRNG
  (:func:`~.sampling.counter_slot_table`), so samples nest: a tick gathers
  only the extension window past the ``filled`` watermark, and only for
  active lanes.
* ESTIMATE runs on a power-of-two width bucket covering the active lanes'
  watermarks.  The bucket index is read on the host once per tick and the
  buffer is sliced to that width (the reference's on-device ``lax.switch``);
  the counter-PRNG draws and the fixed summation order make the answer
  invariant to the bucket.  With ``use_kernel`` the moment sums come from
  the Poisson-bootstrap CUDA kernel.
* FIT/PREDICT/TEST is elementwise per lane plus fixed-order sums.

Every per-lane computation depends only on the lane's own rows and tick
counter ``k``, so a lane's trajectory is the same whether its neighbours
are the same age, frozen, or freshly spliced in (the lane pool).

A GROUP BY query runs as a grouped lane BLOCK (``fused_step(...,
seg_cap=...)``, :func:`fused_grouped`): G lanes of m = 1, lane g bound to
group g by its stratified slot table, each tick one packed gather over the
active lanes' windows and one segment bootstrap pass
(:func:`~.bootstrap.segment_moment_sums`) over the packed stream.

A WARM lane (``LaneParams.warm``, from the serving layer's warm cache) skips
the two-point init design: tick 0 jumps to the cached prediction
``warm_n0`` and the normal TEST is its verification; a stale prediction
extends through the cached coefficients until the lane has an ``l``-deep
profile of its own.  Cold lanes carry all-False rows and run as before.

A SHARDED step (``fused_step(..., shard_spec, data_shards=S)``,
:func:`make_sharded_step`) cuts every lane buffer's slot axis into S
segments, one per row shard of a :class:`~.sampling.ShardLayout`: each
segment gathers its own window from its own rows and computes RAW replicate
moment sums under its own seed stream, and the S partials are combined --
a sequential fold in shard order on one device, or one
:meth:`~.mesh.DataMesh.all_gather_fold` on a mesh, the only collective a
tick crosses.  Everything else is replicated, so a mesh pool drains bit-equal
to the single-device run of the same layout.  Only ``backend="poisson"`` is
ported.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import prng, resolve_use_kernel
from . import (bootstrap, error_model, keys as keylib, sampling, sanitize,
               trace)
from .mesh import DataMesh
from .estimators import get as get_estimator, moment_family_index
from .reduce import tree_sum

LOG_FLOOR = -60.0

_SALT_BOOT = 0xB007        # per-lane bootstrap seed base
_SALT_GROUP = 0x7F4A7C15   # per-(iteration, group) bootstrap stream split
_SALT_SHARD = sampling.SHARD_SALT   # per-shard bootstrap stream split

_I32_MAX = 2147483647


class FusedResult(NamedTuple):
    n: torch.Tensor            # (m,) final sizes
    error: torch.Tensor        # final estimated error
    theta: torch.Tensor        # (m, p) final estimate (scaled)
    iterations: torch.Tensor   # iterations executed
    success: torch.Tensor      # bool: constraint met
    failed: torch.Tensor       # bool: Algorithm-2 unrecoverable failure
    beta: torch.Tensor         # (m+1,) final model parameters
    r2: torch.Tensor
    profile_n: torch.Tensor    # (max_iters, m)
    profile_e: torch.Tensor    # (max_iters,)
    rows_sampled: torch.Tensor  # rows gathered == sum of the filled watermark


class LaneState(NamedTuple):
    """The carried state of the fused loop -- one row per query lane.

    ``keys`` is carried for the non-poisson bootstrap backends of the
    reference, which the port leaves out: it is never read and, unlike the
    reference, not split per tick.  ``buf`` is updated IN PLACE by
    :func:`fused_step` (the buffer is the one large leaf), so a step
    consumes the state it is given.
    """
    keys: torch.Tensor         # (q, 2) int64 lane keys (uint32 patterns)
    k: torch.Tensor            # (q,) int32 per-lane tick counter
    iters: torch.Tensor        # (q,) int32 active-iteration count
    n_cur: torch.Tensor        # (q, m) int32
    filled: torch.Tensor       # (q, m) int32 gathered-slot watermark
    buf: torch.Tensor          # (q, m, n_cap, c) carried nested samples
    prof_n: torch.Tensor       # (q, max_iters, m) f32
    prof_loge: torch.Tensor    # (q, max_iters) f32
    e: torch.Tensor            # (q,) f32
    theta: torch.Tensor        # (q, m, p) f32
    done: torch.Tensor         # (q,) bool, sticky
    failed: torch.Tensor       # (q,) bool, sticky
    beta: torch.Tensor         # (q, m + 1) f32
    r2: torch.Tensor           # (q,) f32


class LaneParams(NamedTuple):
    """Per-lane query parameters -- constant across ticks, spliceable per
    lane.  ``slot_idx`` is ``(m, n_cap)`` when all lanes share one sample key
    or ``(q, m, n_cap)`` per lane.  A lane with ``warm[i]`` set starts from
    the cached prediction ``warm_n0[i]`` and coefficients ``warm_beta[i]``;
    cold lanes carry False / zero rows."""
    scale: torch.Tensor        # (q, m) f32 per-group scale
    epsilons: torch.Tensor     # (q,) f32
    deltas: torch.Tensor       # (q,) f32
    est_fids: torch.Tensor     # (q,) int32 moment-family indices
    boot_base: torch.Tensor    # (q,) int64 uint32 bootstrap seed base
    slot_idx: torch.Tensor     # (m, n_cap) | (q, m, n_cap) int32
    warm: torch.Tensor         # (q,) bool: lane starts from a prediction
    warm_n0: torch.Tensor      # (q, m) int32 the tick-0 jump target
    warm_beta: torch.Tensor    # (q, m + 1) f32 cached coefficients
    group_sizes: torch.Tensor  # (q, m) int32 rows available to each group


def _bucket_widths(n_cap: int, base: int) -> Tuple[int, ...]:
    """Static power-of-two width ladder base, 2*base, ... topped by n_cap."""
    base = min(max(int(base), 1), n_cap)
    widths = []
    w = base
    while w < n_cap:
        widths.append(w)
        w *= 2
    widths.append(n_cap)
    return tuple(widths)


@functools.lru_cache(maxsize=None)
def _bucket_bounds(widths: Tuple[int, ...], dev) -> torch.Tensor:
    """The ladder's bounds below its top rung on ``dev``, uploaded once (a
    named transfer)."""
    with sanitize.harvest("lane_pool.step.upload"):
        return torch.as_tensor(widths[:-1], dtype=torch.int32, device=dev)


def bucket_ladder(n_cap: int, n_max: int) -> Tuple[int, ...]:
    """The ESTIMATE width ladder (shared with the pool's placement)."""
    return _bucket_widths(n_cap, sampling.bucket_cap(min(n_max, n_cap)))


def _window_ladder(cap: int, base: int) -> Tuple[int, ...]:
    """Doubling ladder with midpoints (base, 1.5b, 2b, 3b, 4b, ...) to cap."""
    base = min(max(int(base), 1), cap)
    rungs = set()
    w = base
    while w < cap:
        rungs.add(w)
        mid = w + w // 2
        if mid < cap:
            rungs.add(mid)
        w *= 2
    rungs.add(cap)
    return tuple(sorted(rungs))


def seg_ladder(seg_cap: int, n_max: int) -> Tuple[int, ...]:
    """The reference's packed-stream rungs of the grouped-block ESTIMATE.
    The port sizes its streams exactly; the ladder names the stream lengths
    a block's tick runs at, for measurement and cost models."""
    return _window_ladder(seg_cap, min(sampling.bucket_cap(n_max), seg_cap))


def grouped_seg_cap(offsets, n_cap: int) -> int:
    """Packed-stream capacity of a grouped block: the sum of the per-group
    slot ceilings ``min(size_g, n_cap)``, the most slots the block's windows
    can ever cover."""
    off = np.asarray(offsets, np.int64)
    return int(np.minimum(np.diff(off), n_cap).sum())


def resolve_ext_cap(n_cap: int, n_max: int,
                    ext_cap: Optional[int] = None) -> int:
    """Extension window: the most new rows one active lane-tick gathers."""
    if ext_cap is None:
        ext_cap = min(n_cap, max(sampling.bucket_cap(n_max), n_cap // 8))
    return min(max(ext_cap, n_max), n_cap)


def lane_boot_seed(key) -> int:
    """uint32 bootstrap seed base of one lane key (the _SALT_BOOT stream)."""
    return keylib.bits(keylib.fold_in(key, _SALT_BOOT))


def _host(x, dtype) -> np.ndarray:
    """A host numpy array from an array-like or a tensor on any device."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, dtype)


def resolve_warm_rows(q: int, m: int, warm=None, warm_n0=None,
                      warm_beta=None, *, device) -> Tuple[torch.Tensor,
                                                          torch.Tensor,
                                                          torch.Tensor]:
    """The warm-start leaves of :class:`LaneParams` on ``device``: ``warm``
    None means all-True when a prediction is given, all-False otherwise;
    missing rows are zeros, so cold and warm lanes share one layout."""
    if warm is None:
        warm = np.full((q,), warm_n0 is not None, bool)
    wn0 = (np.zeros((q, m), np.int32) if warm_n0 is None
           else _host(warm_n0, np.int32).reshape(q, m))
    wb = (np.zeros((q, m + 1), np.float32) if warm_beta is None
          else _host(warm_beta, np.float32).reshape(q, m + 1))
    return (torch.as_tensor(_host(warm, np.bool_).reshape(q), device=device),
            torch.as_tensor(wn0, device=device),
            torch.as_tensor(wb, device=device))


def make_lane_params(offsets, scale, keys, epsilons, deltas,
                     sample_keys=None, est_fids=None, *, n_cap: int,
                     warm=None, warm_n0=None, warm_beta=None,
                     device=None) -> LaneParams:
    """Per-lane query parameters (slot tables + seed bases).

    ``keys (q, 2)`` are the lanes' bootstrap keys; ``sample_keys`` ``None``
    derives one slot->row binding per lane from ``keys``, a ``(2,)`` key
    shares ONE binding across lanes, ``(q, 2)`` pins one per lane.
    ``warm``/``warm_n0 (q, m)``/``warm_beta (q, m+1)`` seed warm lanes
    (:func:`resolve_warm_rows`); omitted, every lane is cold.
    """
    dev = torch.device(device) if device is not None else (
        sampling.default_device())
    off = np.asarray(offsets, np.int64)
    starts, sizes = off[:-1], off[1:] - off[:-1]
    keys = _host(keys, np.uint32)
    q = keys.shape[0]
    skeys = keys if sample_keys is None else _host(sample_keys, np.uint32)
    if skeys.ndim == 1:
        slot_idx = sampling.counter_slot_table(skeys, starts, sizes, n_cap,
                                               device=dev)
    else:
        slot_idx = torch.stack([
            sampling.counter_slot_table(sk, starts, sizes, n_cap, device=dev)
            for sk in skeys])
    boot = torch.as_tensor([lane_boot_seed(k) for k in keys],
                           dtype=torch.int64, device=dev)
    if est_fids is None:
        est_fids = np.zeros((q,), np.int32)
    w, wn0, wb = resolve_warm_rows(q, sizes.shape[0], warm, warm_n0,
                                   warm_beta, device=dev)
    return LaneParams(
        scale=torch.as_tensor(_host(scale, np.float32), device=dev),
        epsilons=torch.as_tensor(_host(epsilons, np.float32), device=dev),
        deltas=torch.as_tensor(_host(deltas, np.float32), device=dev),
        est_fids=torch.as_tensor(_host(est_fids, np.int32), device=dev),
        boot_base=boot, slot_idx=slot_idx, warm=w, warm_n0=wn0, warm_beta=wb,
        group_sizes=torch.as_tensor(
            np.broadcast_to(sizes.astype(np.int32), (q, sizes.shape[0])).copy(),
            device=dev))


def make_group_lane_params(offsets, scale, keys, epsilons, deltas,
                           sample_key, est_fids=None, *, n_cap: int,
                           warm=None, warm_n0=None, warm_beta=None,
                           slot_idx: Optional[torch.Tensor] = None,
                           device=None) -> LaneParams:
    """Lane-BLOCK parameters of a grouped query: lane g <- group g.

    ``q = G`` lanes of m = 1: lane g's slot table is the stratified table
    of group g (:func:`~.sampling.stratified_slot_tables`, the solo table of
    group g's slice under ``stratum_key(sample_key, g)`` in global rows) and
    its ``group_sizes`` row is that group's size.  ``scale (G,)``, ``keys
    (G, 2)``, ``epsilons``/``deltas (G,)``; ``warm_n0 (G, 1)`` and
    ``warm_beta (G, 2)`` seed warm lanes; ``slot_idx`` passes the ``(G, 1,
    n_cap)`` tables prebuilt (they depend only on the sample key, the layout
    and ``n_cap``).
    """
    dev = torch.device(device) if device is not None else (
        sampling.default_device())
    off = np.asarray(offsets, np.int64)
    sizes = np.diff(off)
    keys = _host(keys, np.uint32)
    q = keys.shape[0]
    if q != sizes.shape[0]:
        raise ValueError(
            f"grouped block wants one lane per group: got {q} lanes for "
            f"{sizes.shape[0]} groups")
    sample_key = _host(sample_key, np.uint32)
    if sample_key.ndim != 1:
        raise ValueError("a grouped block shares one (2,) sample key")
    if slot_idx is None:
        slot_idx = sampling.stratified_slot_tables(sample_key, off, n_cap,
                                                   device=dev)
    if est_fids is None:
        est_fids = np.zeros((q,), np.int32)
    w, wn0, wb = resolve_warm_rows(q, 1, warm, warm_n0, warm_beta,
                                   device=dev)
    return LaneParams(
        scale=torch.as_tensor(_host(scale, np.float32).reshape(q, 1),
                              device=dev),
        epsilons=torch.as_tensor(_host(epsilons, np.float32), device=dev),
        deltas=torch.as_tensor(_host(deltas, np.float32), device=dev),
        est_fids=torch.as_tensor(_host(est_fids, np.int32), device=dev),
        boot_base=torch.as_tensor([lane_boot_seed(k) for k in keys],
                                  dtype=torch.int64, device=dev),
        slot_idx=slot_idx, warm=w, warm_n0=wn0, warm_beta=wb,
        group_sizes=torch.as_tensor(sizes.astype(np.int32).reshape(q, 1),
                                    device=dev))


def init_lane_state(keys, m: int, *, n_cap: int, c_dim: int, p_dim: int,
                    n_min: int, max_iters: int, device=None,
                    dtype=torch.float32) -> LaneState:
    """Fresh carry for ``q = len(keys)`` lanes (every lane at tick 0)."""
    dev = torch.device(device) if device is not None else (
        sampling.default_device())
    kt = torch.as_tensor(_host(keys, np.uint32).astype(np.int64), device=dev)
    q = kt.shape[0]
    i32, f32 = torch.int32, torch.float32
    return LaneState(
        keys=kt,
        k=torch.zeros((q,), dtype=i32, device=dev),
        iters=torch.zeros((q,), dtype=i32, device=dev),
        n_cur=torch.full((q, m), n_min, dtype=i32, device=dev),
        filled=torch.zeros((q, m), dtype=i32, device=dev),
        buf=torch.zeros((q, m, n_cap, c_dim), dtype=dtype, device=dev),
        prof_n=torch.ones((q, max_iters, m), dtype=f32, device=dev),
        prof_loge=torch.zeros((q, max_iters), dtype=f32, device=dev),
        e=torch.full((q,), float("inf"), dtype=f32, device=dev),
        theta=torch.zeros((q, m, p_dim), dtype=f32, device=dev),
        done=torch.zeros((q,), dtype=torch.bool, device=dev),
        failed=torch.zeros((q,), dtype=torch.bool, device=dev),
        beta=torch.zeros((q, m + 1), dtype=f32, device=dev),
        r2=torch.zeros((q,), dtype=f32, device=dev),
    )


def lane_active(state: LaneState, max_iters: int) -> torch.Tensor:
    """(q,) lanes still iterating: not converged, not failed, ticks left."""
    return ~state.done & ~state.failed & (state.k < max_iters)


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 the way XLA converts: truncate, saturate, NaN -> 0."""
    x = torch.nan_to_num(x, nan=0.0, posinf=float("inf"), neginf=-float("inf"))
    out = x.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    return torch.where(x >= 2147483648.0, torch.full_like(out, _I32_MAX), out)


def _fit_predict(s: LaneState, p: LaneParams, *, tau: float,
                 growth_cap: float, max_iters: int, l: int):
    """FIT + PREDICT for every lane: ``(n_pred (q, m), beta (q, m+1), r2
    (q,), failed_fit (q,))``.

    Warm lanes override their first ``l`` ticks: tick 0 takes ``warm_n0``
    as it is, later ticks extend through the cached coefficients' local
    model (the cold loop's ratio ** (1 / slope) step), the fit's beta is
    replaced by ``warm_beta`` and a fit failure is ignored.  From tick ``l``
    the lane's own profile is full and the ordinary fit takes over."""
    log_eps = torch.log(p.epsilons)
    row_valid = (torch.arange(max_iters, device=s.k.device)[None, :]
                 < s.k[:, None]).to(torch.float32)
    n_hat, fit = error_model.fit_and_predict(
        s.prof_n, s.prof_loge, row_valid, log_eps, tau)
    n_next = _to_i32(torch.ceil(n_hat))
    # Local-model correction from the last iterate.
    slope = torch.clamp(tree_sum(fit.beta[:, 1:], -1), min=1e-3)
    ratio = torch.clamp(s.e / p.epsilons, min=1.0)
    n_cur_f = s.n_cur.to(torch.float32)
    local = _to_i32(torch.ceil(
        n_cur_f * torch.pow(ratio, 1.0 / slope)[:, None]))
    n_next = torch.maximum(n_next, local)
    # Trust region + growth guard.
    cap = _to_i32(n_cur_f * growth_cap) + 1
    n_next = torch.minimum(n_next, cap)
    n_next = torch.maximum(n_next, s.n_cur + 1)
    failed = fit.status == error_model.DIAG_FAILURE
    # Warm override (the growth guard still applies after tick 0).
    use_warm = p.warm & (s.k < l)                              # (q,)
    wslope = torch.clamp(tree_sum(p.warm_beta[:, 1:], -1), min=1e-3)
    wlocal = _to_i32(torch.ceil(
        n_cur_f * torch.pow(ratio, 1.0 / wslope)[:, None]))
    wnext = torch.where((s.k == 0)[:, None], p.warm_n0,
                        torch.minimum(torch.maximum(wlocal, s.n_cur + 1),
                                      cap))
    uw = use_warm[:, None]
    return (torch.where(uw, wnext, n_next),
            torch.where(uw, p.warm_beta, fit.beta),
            torch.where(use_warm, torch.zeros_like(fit.r2), fit.r2),
            failed & ~use_warm)


def _bootstrap_seeds(p: LaneParams, k: torch.Tensor, m: int) -> torch.Tensor:
    """(q, m) per-(tick, group) bootstrap seeds of every lane."""
    lane = prng.hash3(p.boot_base, k.to(torch.int64), _SALT_GROUP)
    grp = torch.arange(m, dtype=torch.int64, device=k.device)
    return prng.hash3(lane[:, None], grp[None, :], _SALT_GROUP)


def _gather_windows(values: torch.Tensor, buf: torch.Tensor,
                    filled: torch.Tensor, win_hi: torch.Tensor,
                    slot_idx: torch.Tensor, lanes: torch.Tensor,
                    ext_cap: int) -> None:
    """Extend lanes ``lanes`` of ``buf`` IN PLACE with their windows
    ``[filled, win_hi)`` (at most ``ext_cap`` new slots per group).

    Every window slot is gathered; slots past ``win_hi`` are redirected to
    the window's first slot with that slot's own new value (or, when the
    window is empty, its current value), so the scatter writes each slot
    once with a well-defined value -- the reference's ``mode="drop"``.
    """
    a = lanes.shape[0]
    if a == 0:
        return
    n_cap = buf.shape[2]
    m = buf.shape[1]
    dev = buf.device
    fl = filled[lanes].to(torch.int64)                         # (a, m)
    hi = win_hi[lanes].to(torch.int64)
    slots = fl[:, :, None] + torch.arange(ext_cap, device=dev)  # (a, m, ext)
    valid = slots < hi[:, :, None]
    clipped = torch.clamp(slots, max=n_cap - 1)
    tab = (slot_idx[lanes] if slot_idx.dim() == 3
           else slot_idx[None].expand(a, -1, -1))
    rows = values[torch.gather(tab, 2, clipped).to(torch.int64)]  # (a, m, ext, c)
    li = lanes[:, None, None].expand_as(slots)
    gi = torch.arange(m, device=dev)[None, :, None].expand_as(slots)
    first = torch.clamp(fl, max=n_cap - 1)                     # (a, m)
    old_first = buf[lanes[:, None], torch.arange(m, device=dev)[None, :],
                    first]                                     # (a, m, c)
    fill_val = torch.where(valid[:, :, :1, None], rows[:, :, :1],
                           old_first[:, :, None])              # (a, m, 1, c)
    tgt = torch.where(valid, slots, first[:, :, None])
    src = torch.where(valid[..., None], rows, fill_val)
    buf.index_put_((li, gi, tgt), src)


def _packed(widths: torch.Tensor, total: int):
    """Owner lane and offset in the window of each element of the stream of
    ``widths (q,)`` windows concatenated in lane order (zero-width lanes own
    nothing: the right-side search skips their repeated starts)."""
    starts = torch.cumsum(widths, 0) - widths
    j = torch.arange(total, dtype=torch.int64, device=widths.device)
    lane = torch.searchsorted(starts, j, right=True) - 1
    return lane, j - starts[lane]


def _segment_tick(values: torch.Tensor, s: LaneState, p: LaneParams, *,
                  active, win_lo, win_hi, seeds, est, B: int, seg_cap: int,
                  metric: str, use_kernel: bool):
    """Shared-scan SAMPLE + ESTIMATE of a grouped lane block.

    The block is ``q`` lanes of m = 1, lane g bound to group g by its
    stratified slot table.  One packed gather over the active lanes'
    extension windows ``[filled, win_hi)`` and one segment bootstrap pass
    over their ESTIMATE windows ``[win_lo, win_hi)`` replace the per-lane
    gather and the shared width bucket, so a tick's cost tracks the rows
    its lanes hold, not ``q`` times the widest.  Windows, slot bindings and
    weight draws are the solo path's and so is the summation order, so a
    block lane's trajectory equals its solo run's bit for bit.

    The reference picks padded stream lengths with ``lax.switch``; here the
    two stream lengths and the slot bound are read on the host in the
    tick's one transfer and both streams are sized exactly, so no element
    is padding and no scatter target repeats.  Returns ``(filled, e_b,
    theta_b)``; ``s.buf`` is extended in place.
    """
    q = active.shape[0]
    with trace.span("lane_pool.step.fit_predict"):
        filled0 = s.filled[:, 0].to(torch.int64)
        lo = win_lo[:, 0].to(torch.int64)
        hi = win_hi[:, 0].to(torch.int64)
        ext_w = torch.clamp(hi - filled0, min=0)   # inactive: hi <= filled
        est_w = torch.where(active, hi - lo, 0)
        bounds = torch.stack([ext_w.sum(), est_w.sum(),
                              torch.amax(torch.where(active, hi, 0))])
    # ---- the tick's one host read: stream lengths + slot bound ----
    with sanitize.harvest("lane_pool.step.read"):
        host = bounds.cpu()
    g_total, e_total, n_slots = (int(v) for v in host)
    if max(g_total, e_total) > seg_cap:
        raise ValueError(f"packed stream of {max(g_total, e_total)} exceeds "
                         f"seg_cap={seg_cap}: params and seg_cap disagree")
    # ---- one packed gather over the extension windows ----
    with trace.span("lane_pool.step.gather"):
        lane_j, off_j = _packed(ext_w, g_total)
        slot_j = filled0[lane_j] + off_j
        rows = p.slot_idx[lane_j, 0, slot_j].to(torch.int64)
        s.buf[lane_j, 0, slot_j] = values[rows]
        filled = torch.maximum(s.filled, win_hi)
    # ---- one segment bootstrap pass over the ESTIMATE windows ----
    with trace.span("lane_pool.step.estimate"):
        lane_j, off_j = _packed(est_w, e_total)
        slot_j = lo[lane_j] + off_j
        x_j = s.buf[lane_j, 0, slot_j, 0]
        M, M_plain = bootstrap.segment_moment_sums(
            x_j, lane_j, slot_j, torch.ones_like(x_j), seeds[:, 0], q, B,
            use_kernel=use_kernel, n_slots=n_slots)
        e_b, theta_b = bootstrap.finish_lanes_moments(
            M[:, None], M_plain[:, None], p.scale, p.deltas, est=est,
            est_fids=p.est_fids, metric=metric)
    return filled, e_b, theta_b


def _step_body(values: torch.Tensor, s: LaneState, p: LaneParams, *,
               est_name: Optional[str], B: int, n_min: int, n_max: int,
               l: int, tau: float, max_iters: int, n_cap: int, metric: str,
               growth_cap: float, ext_cap: int, adaptive: bool,
               use_kernel: bool, gate_gather: bool,
               seg_cap: Optional[int] = None) -> LaneState:
    """One SAMPLE -> ESTIMATE -> FIT -> PREDICT -> TEST tick over all lanes.

    Reads two things on the host, in one transfer: the ESTIMATE bucket index
    and the active-lane mask (which lanes gather).  ``seg_cap`` runs a
    grouped block's tick instead (:func:`_segment_tick`, its own one read).
    """
    est = get_estimator(est_name) if est_name is not None else None
    q, m = s.n_cur.shape
    dev = s.k.device
    # Deterministic balanced two-point design (Eq. 15/16).
    l_min = min(max(int(round(l * n_max / (n_min + n_max))), 1), l - 1)
    widths = bucket_ladder(n_cap, n_max) if adaptive else (n_cap,)

    with trace.span("lane_pool.step.fit_predict"):
        active = lane_active(s, max_iters)                     # (q,)
        act2 = active[:, None]
        phase = (s.k[:, None] + torch.arange(m, device=dev)[None, :]) % l
        n_init = torch.where(phase < l_min, n_min, n_max).to(torch.int32)
        n_pred, beta, r2, failed_fit = _fit_predict(
            s, p, tau=tau, growth_cap=growth_cap, max_iters=max_iters, l=l)
        # Warm lanes take the prediction branch from tick 0.
        init_phase = (s.k < l) & ~p.warm                       # (q,)
        n_vec = torch.where(init_phase[:, None], n_init, n_pred)
        n_vec = torch.minimum(torch.clamp(n_vec, min=1),
                              torch.clamp(p.group_sizes, max=n_cap))
        n_vec = torch.minimum(n_vec, s.filled + ext_cap)
        n_vec = torch.where(act2, n_vec, s.n_cur)
        # Init probes read stacked windows [filled, filled + n); prediction
        # ticks reuse the whole prefix (win_lo = 0).
        win_lo = torch.where(init_phase[:, None],
                             torch.minimum(s.filled, n_cap - n_vec),
                             torch.zeros_like(n_vec))
        win_lo = torch.where(act2, win_lo, torch.zeros_like(win_lo))
        win_hi = torch.where(act2, win_lo + n_vec,
                             torch.minimum(s.n_cur, s.filled))
        seeds = _bootstrap_seeds(p, s.k, m)
        if seg_cap is None:
            needed = torch.clamp(torch.amax(torch.where(act2, win_hi, 0)),
                                 min=1)
            b_idx = torch.sum(needed > _bucket_bounds(widths, dev)).to(
                torch.int64).reshape(1)
            host_ask = torch.cat([b_idx, active.to(torch.int64)])
    if seg_cap is not None:
        filled, e_b, theta_b = _segment_tick(
            values, s, p, active=active, win_lo=win_lo, win_hi=win_hi,
            seeds=seeds, est=est, B=B, seg_cap=seg_cap, metric=metric,
            use_kernel=use_kernel)
    else:
        # ---- the tick's one host read: bucket index + active lanes ----
        with sanitize.harvest("lane_pool.step.read"):
            host = host_ask.cpu().numpy()
            width = widths[int(host[0])]
            gather_lanes = torch.as_tensor(
                np.nonzero(host[1:])[0] if gate_gather else np.arange(q),
                dtype=torch.int64, device=dev)
        # ---- extend the carried nested samples by the window only ----
        with trace.span("lane_pool.step.gather"):
            _gather_windows(values, s.buf, s.filled, win_hi, p.slot_idx,
                            gather_lanes, ext_cap)
            filled = torch.maximum(s.filled, win_hi)
        # ---- bootstrap estimate on the active width bucket ----
        with trace.span("lane_pool.step.estimate"):
            bw = s.buf[:, :, :width]
            pos = torch.arange(width, dtype=torch.int32,
                               device=dev)[None, None, :]
            msk = ((pos >= win_lo[:, :, None]) &
                   (pos < win_hi[:, :, None])).to(torch.float32)
            if est is None:
                e_b, theta_b = bootstrap.estimate_error_lanes_het(
                    bw, msk, seeds, p.est_fids, p.scale, p.deltas, B=B,
                    metric=metric, use_kernel=use_kernel, lane_active=active)
            else:
                e_b, theta_b = bootstrap.estimate_error_lanes(
                    est, bw, msk, seeds, p.scale, p.deltas, B=B,
                    metric=metric, use_kernel=use_kernel, lane_active=active)
    with trace.span("lane_pool.step.test"):
        return _lane_epilogue(
            s, p, max_iters=max_iters, active=active, init_phase=init_phase,
            e_b=e_b, theta_b=theta_b, n_eff=n_vec, filled=filled, beta=beta,
            r2=r2, failed_fit=failed_fit)


def _lane_epilogue(s: LaneState, p: LaneParams, *, max_iters, active,
                   init_phase, e_b, theta_b, n_eff, filled, beta, r2,
                   failed_fit) -> LaneState:
    """TEST + the predicated state merge."""
    q = active.shape[0]
    loge = torch.clamp(torch.log(torch.clamp(e_b, min=1e-30)), min=LOG_FLOOR)
    qi = torch.arange(q, device=active.device)
    kq = torch.clamp(s.k, max=max_iters - 1).to(torch.int64)
    prof_n = s.prof_n.clone()
    prof_n[qi, kq] = torch.where(active[:, None], n_eff.to(torch.float32),
                                 s.prof_n[qi, kq])
    prof_loge = s.prof_loge.clone()
    prof_loge[qi, kq] = torch.where(active, loge, s.prof_loge[qi, kq])
    done = s.done | (active & (e_b <= p.epsilons))
    failed = s.failed | (active & ~init_phase & failed_fit)
    fit_ok = active & ~init_phase
    return LaneState(
        keys=s.keys, k=s.k + 1, iters=s.iters + active.to(torch.int32),
        n_cur=torch.where(active[:, None], n_eff, s.n_cur),
        filled=filled, buf=s.buf, prof_n=prof_n, prof_loge=prof_loge,
        e=torch.where(active, e_b, s.e),
        theta=torch.where(active[:, None, None], theta_b, s.theta),
        done=done, failed=failed,
        beta=torch.where(fit_ok[:, None], beta, s.beta),
        r2=torch.where(fit_ok, r2, s.r2),
    )


# ---------------------------------------------------------------------------
# The sharded step: the same tick over S row shards
# ---------------------------------------------------------------------------

class ShardSpec(NamedTuple):
    """Device-side shard layout tables of the sharded step: ``alloc[s, i,
    n]`` counts the first ``n`` logical slots of group i that segment s owns
    (:class:`~.sampling.ShardLayout`), ``cap_groups[i]`` is group i's logical
    slot capacity.  Every rank of a mesh holds the whole stack: the growth
    clamp reads every segment's table."""
    alloc: torch.Tensor        # (S, m, n_cap + 1) int32
    cap_groups: torch.Tensor   # (m,) int32


def make_shard_spec(layout: sampling.ShardLayout, device=None) -> ShardSpec:
    """Lift a host :class:`~.sampling.ShardLayout` onto ``device``."""
    dev = torch.device(device) if device is not None else (
        sampling.default_device())
    return ShardSpec(alloc=torch.as_tensor(layout.alloc, device=dev),
                     cap_groups=torch.as_tensor(layout.cap_groups, device=dev))


def resolve_seg_window(n_cap: int, n_max: int, data_shards: int,
                       ext_cap: Optional[int] = None) -> int:
    """Per-SEGMENT extension window of the sharded step: each segment's
    proportional share of the global window :func:`resolve_ext_cap` plus an
    imbalance slack.  The step's growth clamp makes any window safe: a skewed
    stretch of the alloc tables costs extra ticks, never missing rows."""
    if n_cap % data_shards:
        raise ValueError(
            f"n_cap={n_cap} must divide by data_shards={data_shards}")
    cap_s = n_cap // data_shards
    if n_max > cap_s:
        raise ValueError(
            f"n_max={n_max} exceeds one shard segment ({cap_s} slots); "
            f"raise n_cap or lower data_shards")
    ext_global = resolve_ext_cap(n_cap, n_max, ext_cap)
    share = -(-ext_global // data_shards)
    return min(cap_s, share + max(share // 4, 32))


def _sharded_step_body(values: torch.Tensor, s: LaneState, p: LaneParams,
                       spec: ShardSpec, *, est_name: Optional[str], B: int,
                       n_min: int, n_max: int, l: int, tau: float,
                       max_iters: int, n_cap: int, metric: str,
                       growth_cap: float, seg_window: int, use_kernel: bool,
                       data_shards: int,
                       mesh: Optional[DataMesh] = None) -> LaneState:
    """One tick with the buffer slot axis cut into S shard segments.

    The decisions are :func:`_step_body`'s; SAMPLE and the replicate moment
    pass run per segment: segment s gathers its share of each window from
    its own rows (its ``alloc`` table says how many slots it owns), and sums
    the window under the seed stream ``hash3(seeds, s, SHARD_SALT)``.  The
    RAW sums are combined by a left fold in shard order: here on one device
    (``mesh=None``: ``values`` the whole padded table, ``s.buf`` all S
    segments, ``p.slot_idx (S, m, seg_cap)`` in global rows), or, on a
    mesh, this rank's segment only (``values`` its row block, ``s.buf`` its
    ``(q, m, seg_cap, c)`` segment, ``p.slot_idx (1, m, seg_cap)`` in local
    rows) and one :meth:`~.mesh.DataMesh.all_gather_fold` of the flattened
    ``(q, m, B, 3)`` and ``(q, m, 3)`` sums, the tick's only collective.  The
    growth clamp reads every segment's alloc table on every rank, so it needs
    none.  One host read a tick: the active lanes and each segment's widest
    active window.  The card takes one shared prefix rung a segment and one
    Poisson-bootstrap launch (:func:`~.bootstrap.prefix_lane_moment_sums`);
    the plain path windows chunks of lanes
    (:func:`~.bootstrap.windowed_lane_moment_sums`), bit-equal to it.
    """
    est = get_estimator(est_name) if est_name is not None else None
    S = data_shards
    cap_s = n_cap // S
    q, m = s.n_cur.shape
    dev = s.k.device
    l_min = min(max(int(round(l * n_max / (n_min + n_max))), 1), l - 1)
    # Per-segment ESTIMATE rungs: from the segment's share of n_min (a
    # window holds ~1/S of a lane's rows) up to the segment capacity.
    seg_base = max(min(-(-n_max // S), -(-n_min // S)), 32)
    seg_widths = _window_ladder(cap_s, min(seg_base, cap_s))

    active = lane_active(s, max_iters)                         # (q,)
    act2 = active[:, None]
    phase = (s.k[:, None] + torch.arange(m, device=dev)[None, :]) % l
    n_init = torch.where(phase < l_min, n_min, n_max).to(torch.int32)
    n_pred, beta, r2, failed_fit = _fit_predict(
        s, p, tau=tau, growth_cap=growth_cap, max_iters=max_iters, l=l)
    init_phase = (s.k < l) & ~p.warm                           # (q,)
    n_vec = torch.where(init_phase[:, None], n_init, n_pred)
    n_vec = torch.minimum(torch.clamp(n_vec, min=1), spec.cap_groups[None, :])

    def local(idx: torch.Tensor) -> torch.Tensor:
        """(S, q, m) segment-local slot counts at logical slots ``idx``."""
        at = idx.to(torch.int64).T[None].expand(S, m, q)
        return torch.gather(spec.alloc, 2, at).transpose(1, 2)

    # ---- cross-shard growth clamp: a segment grows by at most seg_window
    # local slots a tick, so the logical watermark grows only as far as
    # every segment's share fits.
    lfill = local(s.filled)                                    # (S, q, m)
    hi = torch.searchsorted(spec.alloc,
                            (lfill + seg_window).transpose(1, 2).contiguous(),
                            right=True)                        # (S, m, q)
    allowed = (torch.amin(hi, 0).T - 1 - s.filled).to(torch.int32)
    # An init probe's window is stacked at the watermark, so its size is its
    # growth; a prediction tick reads the prefix [0, n), so it may reach the
    # watermark plus the growth.  (The reference clamps both by the growth
    # alone, which stalls a prediction below its own watermark.)
    n_vec = torch.minimum(n_vec, torch.where(init_phase[:, None], allowed,
                                             s.filled + allowed))
    n_vec = torch.where(act2, n_vec, s.n_cur)
    win_lo = torch.where(init_phase[:, None],
                         torch.minimum(s.filled,
                                       spec.cap_groups[None, :] - n_vec),
                         torch.zeros_like(n_vec))
    win_lo = torch.where(act2, win_lo, torch.zeros_like(win_lo))
    win_hi = torch.where(act2, win_lo + n_vec,
                         torch.minimum(s.n_cur, s.filled))
    filled = torch.maximum(s.filled, win_hi)
    seeds = _bootstrap_seeds(p, s.k, m)
    llo, lhi = local(win_lo), local(win_hi)
    # ---- the tick's one host read: active lanes + widest active windows ----
    need = torch.amax(torch.where(act2[None], lhi, 0).reshape(S, -1), 1)
    with sanitize.harvest("lane_pool.step.read"):
        host = torch.cat([active.to(torch.int64),
                          need.to(torch.int64)]).cpu().numpy()
        lanes = torch.as_tensor(np.nonzero(host[:q])[0], dtype=torch.int64,
                                device=dev)

    def seg_tick(si: int, buf_seg: torch.Tensor, table: torch.Tensor):
        """Gather + RAW moment sums of segment ``si`` (``buf_seg`` a view of
        its ``(q, m, cap_s, c)`` slots, updated in place)."""
        _gather_windows(values, buf_seg, lfill[si], lhi[si], table, lanes,
                        seg_window)
        seeds_s = prng.hash3(seeds, si, _SALT_SHARD)
        vals = buf_seg[..., 0]
        if use_kernel:
            needed = max(int(host[q + si]), 1)
            width = seg_widths[sum(needed > w for w in seg_widths[:-1])]
            return bootstrap.prefix_lane_moment_sums(
                vals, llo[si], lhi[si], seeds_s, B, width,
                lane_active=active, use_kernel=True)
        return bootstrap.windowed_lane_moment_sums(
            vals, llo[si], lhi[si], seeds_s, B, seg_widths,
            lane_active=active)

    if mesh is None:
        parts = [seg_tick(si, s.buf[:, :, si * cap_s:(si + 1) * cap_s],
                          p.slot_idx[si]) for si in range(S)]
        M, Mp = parts[0]
        for M_s, Mp_s in parts[1:]:
            M = M + M_s
            Mp = Mp + Mp_s
    else:
        M_s, Mp_s = seg_tick(mesh.rank, s.buf, p.slot_idx[0])
        k = M_s.numel()
        flat = mesh.all_gather_fold(torch.cat([M_s.reshape(-1),
                                               Mp_s.reshape(-1)]))
        M, Mp = flat[:k].reshape(M_s.shape), flat[k:].reshape(Mp_s.shape)
    e_b, theta_b = bootstrap.finish_lanes_moments(
        M, Mp, p.scale, p.deltas, est=est, est_fids=p.est_fids, metric=metric)
    return _lane_epilogue(
        s, p, max_iters=max_iters, active=active, init_phase=init_phase,
        e_b=e_b, theta_b=theta_b, n_eff=n_vec, filled=filled, beta=beta,
        r2=r2, failed_fit=failed_fit)


def make_sharded_lane_params(layout: sampling.ShardLayout, scale, keys,
                             epsilons, deltas, sample_key, est_fids=None, *,
                             local_rows: bool, warm=None, warm_n0=None,
                             warm_beta=None, device=None) -> LaneParams:
    """Per-lane parameters of the sharded step: stacked ``(S, m, seg_cap)``
    slot tables under ONE shared ``(2,)`` sample key (per-lane bindings are
    not supported), in each shard's local rows (``local_rows=True``, the
    mesh) or global rows of the padded table.  Seed bases as
    :func:`make_lane_params` derives them, so a lane's streams match its
    solo run; ``group_sizes`` holds the layout's ``cap_groups``."""
    dev = torch.device(device) if device is not None else (
        sampling.default_device())
    sample_key = _host(sample_key, np.uint32)
    if sample_key.ndim != 1:
        raise ValueError("sharded lanes require one shared (2,) sample key")
    keys = _host(keys, np.uint32)
    q = keys.shape[0]
    m = layout.cap_groups.shape[0]
    if est_fids is None:
        est_fids = np.zeros((q,), np.int32)
    w, wn0, wb = resolve_warm_rows(q, m, warm, warm_n0, warm_beta, device=dev)
    return LaneParams(
        scale=torch.as_tensor(_host(scale, np.float32), device=dev),
        epsilons=torch.as_tensor(_host(epsilons, np.float32), device=dev),
        deltas=torch.as_tensor(_host(deltas, np.float32), device=dev),
        est_fids=torch.as_tensor(_host(est_fids, np.int32), device=dev),
        boot_base=torch.as_tensor([lane_boot_seed(k) for k in keys],
                                  dtype=torch.int64, device=dev),
        slot_idx=sampling.sharded_slot_tables(sample_key, layout,
                                              local_rows=local_rows,
                                              device=dev),
        warm=w, warm_n0=wn0, warm_beta=wb,
        group_sizes=torch.as_tensor(
            np.broadcast_to(layout.cap_groups, (q, m)).copy(), device=dev))


def make_sharded_step(mesh: DataMesh, *, num_ticks: int = 1, **statics):
    """The mesh tick: ``step(values, state, params, shard_spec) -> state``
    runs ``num_ticks`` sharded ticks of this rank (``values`` its row block,
    ``state.buf`` its segment, ``params.slot_idx`` its ``(1, m, seg_cap)``
    local table), one collective a tick.  ``statics`` are the sharded
    body's keywords (``est_name``, ``B``, ``n_min``, ``n_max``, ``l``,
    ``tau``, ``max_iters``, ``n_cap``, ``metric``, ``growth_cap``,
    ``seg_window`` resolved by :func:`resolve_seg_window`, ``use_kernel``,
    ``data_shards``).  Nothing compiles, so there is nothing to memoise."""
    if mesh.size != statics["data_shards"]:
        raise ValueError(f"mesh has {mesh.size} ranks; the step wants "
                         f"data_shards={statics['data_shards']}")

    def step(values: torch.Tensor, state: LaneState, params: LaneParams,
             shard_spec: ShardSpec) -> LaneState:
        if params.slot_idx.dim() != 3 or params.slot_idx.shape[0] != 1:
            raise ValueError("a mesh rank takes its own (1, m, seg_cap) "
                             "local slot table")
        for _ in range(num_ticks):
            state = _sharded_step_body(values, state, params, shard_spec,
                                       mesh=mesh, **statics)
        return state

    return step


def fused_step(values: torch.Tensor, offsets, state: LaneState,
               params: LaneParams, shard_spec: Optional[ShardSpec] = None, *,
               est_name: Optional[str] = None,
               B: int = 500, n_min: int = 100, n_max: int = 200, l: int = 10,
               tau: float = 1e-3, max_iters: int = 32, n_cap: int = 1 << 16,
               metric: str = "l2", growth_cap: float = 8.0,
               ext_cap: Optional[int] = None, adaptive: bool = True,
               use_kernel: "bool | str" = "auto", gate_gather: bool = True,
               data_shards: int = 1, seg_window: Optional[int] = None,
               seg_cap: Optional[int] = None, num_ticks: int = 1) -> LaneState:
    """Host-callable resumable step: ``num_ticks`` ticks over all lanes.

    Converged/failed/exhausted lanes freeze (predicated updates), so ticking
    past a lane's convergence is harmless.  ``est_name=None`` selects each
    lane's estimator from ``params.est_fids``.  ``offsets`` is the group
    layout the params were built for.  The state's ``buf`` is updated in
    place.

    ``data_shards > 1`` runs the SHARDED body on one device -- the
    sequential-fold reference a mesh step reproduces bit for bit.  It needs a
    ``shard_spec`` (:func:`make_shard_spec`) and stacked slot tables
    (:func:`make_sharded_lane_params` with ``local_rows=False``) over the
    padded table; ``ext_cap`` keeps its global meaning and resolves to a
    per-segment window (:func:`resolve_seg_window`), which ``seg_window``
    gives exactly instead.

    ``seg_cap`` selects the grouped lane BLOCK path: ``q`` lanes of m = 1,
    each bound to one group by :func:`make_group_lane_params`, ticked with
    one packed gather and one segment bootstrap pass.  Pass
    :func:`grouped_seg_cap` of the block's layout and the dummy ``[0, N]``
    step offsets (the per-group sizes live in ``params.group_sizes``); it
    needs the adaptive path, a moment-family estimator and one shard.
    """
    if len(offsets) - 1 != state.n_cur.shape[1]:
        raise ValueError("offsets do not match the state's group count")
    if seg_window is not None and data_shards == 1:
        raise ValueError("seg_window applies to the sharded step only")
    if seg_cap is not None:
        if data_shards > 1:
            raise ValueError("seg_cap (grouped blocks) is single-shard only")
        if not adaptive:
            raise ValueError("grouped blocks require the adaptive path")
        if len(offsets) != 2:
            raise ValueError(
                "a grouped block is q lanes of m=1 (one lane per group); "
                "pass the dummy [0, N] step offsets")
        if params.slot_idx.dim() != 3:
            raise ValueError("grouped blocks need per-lane stratified slot "
                             "tables (make_group_lane_params)")
        if est_name is not None:
            moment_family_index(est_name)   # raises for non-moment ests
    use_kernel = resolve_use_kernel(use_kernel, values.device)
    if data_shards > 1:
        if shard_spec is None:
            raise ValueError("data_shards > 1 requires a shard_spec")
        if not adaptive:
            raise ValueError(
                "the sharded step supports the adaptive poisson path only")
        if (params.slot_idx.dim() != 3
                or params.slot_idx.shape[0] != data_shards):
            raise ValueError(
                "sharded lanes need stacked (S, m, seg_cap) slot tables "
                "(make_sharded_lane_params)")
        sspec = dict(
            est_name=est_name, B=B, n_min=n_min, n_max=n_max, l=l, tau=tau,
            max_iters=max_iters, n_cap=n_cap, metric=metric,
            growth_cap=growth_cap,
            seg_window=(seg_window if seg_window is not None else
                        resolve_seg_window(n_cap, n_max, data_shards,
                                           ext_cap)),
            use_kernel=use_kernel, data_shards=data_shards)
        for _ in range(num_ticks):
            state = _sharded_step_body(values, state, params, shard_spec,
                                       **sspec)
        return state
    spec = dict(
        est_name=est_name, B=B, n_min=n_min, n_max=n_max, l=l, tau=tau,
        max_iters=max_iters, n_cap=n_cap, metric=metric,
        growth_cap=growth_cap, ext_cap=resolve_ext_cap(n_cap, n_max, ext_cap),
        adaptive=adaptive, use_kernel=use_kernel,
        gate_gather=gate_gather, seg_cap=seg_cap)
    for _ in range(num_ticks):
        state = _step_body(values, state, params, **spec)
    return state


def lanes_result(state: LaneState) -> FusedResult:
    """Project the carried state onto the public result contract."""
    max_iters = state.prof_loge.shape[1]
    row_live = (torch.arange(max_iters, device=state.k.device)[None, :]
                < state.iters[:, None])
    return FusedResult(
        n=state.n_cur, error=state.e, theta=state.theta,
        iterations=state.iters, success=state.done, failed=state.failed,
        beta=state.beta, r2=state.r2, profile_n=state.prof_n,
        profile_e=torch.exp(state.prof_loge) * row_live,
        rows_sampled=torch.sum(state.filled.to(torch.int64), dim=1))


def fused_l2miss_lanes(values: torch.Tensor, offsets, scale, keys, epsilons,
                       deltas, sample_keys=None, est_fids=None, warm_n0=None,
                       warm_beta=None, *, data_shards: int = 1,
                       shard_layout: Optional[sampling.ShardLayout] = None,
                       est_name: Optional[str] = "avg", B: int = 500,
                       n_min: int = 100, n_max: int = 200, l: int = 10,
                       tau: float = 1e-3, max_iters: int = 32,
                       n_cap: int = 1 << 16, metric: str = "l2",
                       growth_cap: float = 8.0, ext_cap: Optional[int] = None,
                       adaptive: bool = True,
                       use_kernel: "bool | str" = "auto",
                       gate_gather: bool = True) -> FusedResult:
    """q query lanes over one resident table, ticked until every lane is
    done, failed or out of ticks.  A lane's trajectory equals its solo run
    with the same keys: the width bucket is compute width only.
    ``warm_n0 (q, m)``/``warm_beta (q, m+1)`` (both or neither) start every
    lane from a cached prediction, as a pool's warm splice does.

    ``data_shards > 1`` runs the SHARDED step on one device (the sequential
    fold a mesh reproduces): one shared ``(2,)`` sample key (default
    ``keys[0]`` when q == 1), the adaptive path, no warm start (a sharded
    pool takes warm rows through its splice); ``shard_layout`` skips
    rebuilding the host tables and ``ext_cap`` becomes the per-segment
    window."""
    if (warm_n0 is None) != (warm_beta is None):
        raise ValueError("warm_n0 and warm_beta come together")
    dev = values.device
    m = len(offsets) - 1
    use_kernel = resolve_use_kernel(use_kernel, dev)
    p_dim = (get_estimator(est_name).out_dim(values.shape[1])
             if est_name is not None else 1)
    state = init_lane_state(keys, m, n_cap=n_cap, c_dim=values.shape[1],
                            p_dim=p_dim, n_min=n_min, max_iters=max_iters,
                            device=dev, dtype=values.dtype)
    if data_shards > 1:
        if warm_n0 is not None:
            raise ValueError(
                "warm start on the closed sharded loop is not supported; "
                "use a sharded LanePool splice instead")
        if not adaptive:
            raise ValueError(
                "the sharded loop supports the adaptive poisson path only")
        if sample_keys is None:
            if _host(keys, np.uint32).shape[0] != 1:
                raise ValueError(
                    "sharded lanes require one shared (2,) sample key")
            sample_keys = _host(keys, np.uint32)[0]
        layout = shard_layout if shard_layout is not None else (
            sampling.ShardLayout.build(offsets, n_cap=n_cap,
                                       num_shards=data_shards))
        params = make_sharded_lane_params(
            layout, scale, keys, epsilons, deltas, sample_keys, est_fids,
            local_rows=False, device=dev)
        sspec = dict(
            est_name=est_name, B=B, n_min=n_min, n_max=n_max, l=l, tau=tau,
            max_iters=max_iters, n_cap=n_cap, metric=metric,
            growth_cap=growth_cap,
            seg_window=resolve_seg_window(n_cap, n_max, data_shards, ext_cap),
            use_kernel=use_kernel, data_shards=data_shards)
        shard_spec = make_shard_spec(layout, device=dev)
        while bool(lane_active(state, max_iters).any()):
            state = _sharded_step_body(values, state, params, shard_spec,
                                       **sspec)
        return lanes_result(state)
    params = make_lane_params(offsets, scale, keys, epsilons, deltas,
                              sample_keys, est_fids, n_cap=n_cap,
                              warm_n0=warm_n0, warm_beta=warm_beta,
                              device=dev)
    spec = dict(
        est_name=est_name, B=B, n_min=n_min, n_max=n_max, l=l, tau=tau,
        max_iters=max_iters, n_cap=n_cap, metric=metric,
        growth_cap=growth_cap, ext_cap=resolve_ext_cap(n_cap, n_max, ext_cap),
        adaptive=adaptive, use_kernel=use_kernel, gate_gather=gate_gather)
    while bool(lane_active(state, max_iters).any()):
        state = _step_body(values, state, params, **spec)
    return lanes_result(state)


def fused_l2miss(values: torch.Tensor, offsets, scale, key, epsilon, delta,
                 sample_key=None, warm_n0=None, warm_beta=None,
                 **static_kwargs) -> FusedResult:
    """Single-query entry point: the q = 1 lane configuration (``warm_n0
    (m,)``/``warm_beta (m+1,)`` start it warm)."""
    res = fused_l2miss_lanes(
        values, offsets, _host(scale, np.float32)[None],
        _host(key, np.uint32)[None],
        _host(epsilon, np.float32).reshape(1),
        _host(delta, np.float32).reshape(1), sample_key,
        warm_n0=None if warm_n0 is None else _host(warm_n0, np.int32)[None],
        warm_beta=None if warm_beta is None
        else _host(warm_beta, np.float32)[None], **static_kwargs)
    return FusedResult(*(x[0] for x in res))


def fused_grouped(values: torch.Tensor, offsets, scale, key, epsilon, delta,
                  sample_key=None, est_fids=None, warm_n0=None,
                  warm_beta=None, *,
                  est_name: Optional[str] = "avg", B: int = 500,
                  n_min: int = 100, n_max: int = 200, l: int = 10,
                  tau: float = 1e-3, max_iters: int = 32,
                  n_cap: int = 1 << 16, metric: str = "l2",
                  growth_cap: float = 8.0, ext_cap: Optional[int] = None,
                  use_kernel: "bool | str" = "auto") -> FusedResult:
    """GROUP BY entry point: one grouped lane block of ``G = len(offsets) -
    1`` per-group lanes run to the end.

    Lane g's bootstrap key is ``fold_in(key, g)`` and its slot table the
    stratified table of group g under ``sample_key`` (default ``key``);
    each group converges, extends and parks on its own ``(epsilon, delta)``
    row (scalars or ``(G,)``).  The result equals G solo
    :func:`fused_l2miss` runs on the group slices with those keys and
    ``stratum_key(sample_key, g)`` bindings, bit for bit.  ``warm_n0
    (G,)``/``warm_beta (G, 2)`` (both or neither) start every lane warm, as
    a pool's warm block does.

    Returns a :class:`FusedResult` with the GROUP axis leading and the m = 1
    axis squeezed: ``n (G,)``, ``error (G,)``, ``theta (G, p)``,
    ``success (G,)``, ``profile_n (G, max_iters)``.
    """
    if (warm_n0 is None) != (warm_beta is None):
        raise ValueError("warm_n0 and warm_beta come together")
    dev = values.device
    off = np.asarray(offsets, np.int64)
    G = off.shape[0] - 1
    key = keylib.as_key(_host(key, np.uint32))
    keys = np.stack([keylib.fold_in(key, g) for g in range(G)])
    epsilons = np.broadcast_to(_host(epsilon, np.float32), (G,))
    deltas = np.broadcast_to(_host(delta, np.float32), (G,))
    params = make_group_lane_params(
        off, scale, keys, epsilons, deltas,
        key if sample_key is None else sample_key, est_fids, n_cap=n_cap,
        warm_n0=warm_n0, warm_beta=warm_beta, device=dev)
    p_dim = (get_estimator(est_name).out_dim(values.shape[1])
             if est_name is not None else 1)
    state = init_lane_state(keys, 1, n_cap=n_cap, c_dim=values.shape[1],
                            p_dim=p_dim, n_min=n_min, max_iters=max_iters,
                            device=dev, dtype=values.dtype)
    spec = dict(
        est_name=est_name, B=B, n_min=n_min, n_max=n_max, l=l, tau=tau,
        max_iters=max_iters, n_cap=n_cap, metric=metric,
        growth_cap=growth_cap, ext_cap=ext_cap, use_kernel=use_kernel,
        seg_cap=grouped_seg_cap(off, n_cap))
    step_offsets = [0, int(values.shape[0])]
    while bool(lane_active(state, max_iters).any()):
        state = fused_step(values, step_offsets, state, params, **spec)
    res = lanes_result(state)
    return res._replace(n=res.n[:, 0], theta=res.theta[:, 0],
                        profile_n=res.profile_n[:, :, 0])


def fused_l2miss_batch(values_batch: torch.Tensor, offsets, scale_batch, keys,
                       epsilons, delta, sample_keys=None, **static_kwargs
                       ) -> FusedResult:
    """Batch entry point: shared-operand lanes or legacy per-lane tables.

    * ``values_batch (N, c)``: SHARED-OPERAND lanes over one resident
      table; ``scale_batch (q, m)``, ``keys (q, 2)``, ``epsilons (q,)``,
      ``delta`` (scalar or ``(q,)``) and ``sample_keys`` carry the lane
      axis (:func:`fused_l2miss_lanes`).
    * ``values_batch (q, N, c)``: the legacy per-lane tables.  Lane i is
      the solo run :func:`fused_l2miss` on table i at full width
      (``adaptive=False``, as the reference's vmap forces), the lanes run
      one after another and their results stacked on a leading axis.  A
      single ``(2,)`` sample key is shared by every lane."""
    epsilons = _host(epsilons, np.float32)
    q = epsilons.shape[0]
    deltas = np.broadcast_to(_host(delta, np.float32), (q,))
    if values_batch.dim() == 2:
        return fused_l2miss_lanes(values_batch, offsets, scale_batch, keys,
                                  epsilons, deltas, sample_keys,
                                  **static_kwargs)
    kw = dict(static_kwargs, adaptive=False)
    keys = _host(keys, np.uint32)
    scale_batch = _host(scale_batch, np.float32)
    if sample_keys is not None:
        sample_keys = np.broadcast_to(_host(sample_keys, np.uint32), (q, 2))
    runs = [fused_l2miss(values_batch[i], offsets, scale_batch[i], keys[i],
                         epsilons[i], deltas[i],
                         None if sample_keys is None else sample_keys[i],
                         **kw) for i in range(q)]
    return FusedResult(*(torch.stack(x) for x in zip(*runs)))
