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
are the same age, frozen, or freshly spliced in (the lane pool).  Only the
single-device, ``backend="poisson"``, cold-start path is here; grouped
blocks, sharding and warm starts are later slices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels import prng, resolve_use_kernel
from . import bootstrap, error_model, keys as keylib, sampling
from .estimators import get as get_estimator
from .reduce import tree_sum

LOG_FLOOR = -60.0

_SALT_BOOT = 0xB007        # per-lane bootstrap seed base
_SALT_GROUP = 0x7F4A7C15   # per-(iteration, group) bootstrap stream split

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
    or ``(q, m, n_cap)`` per lane."""
    scale: torch.Tensor        # (q, m) f32 per-group scale
    epsilons: torch.Tensor     # (q,) f32
    deltas: torch.Tensor       # (q,) f32
    est_fids: torch.Tensor     # (q,) int32 moment-family indices
    boot_base: torch.Tensor    # (q,) int64 uint32 bootstrap seed base
    slot_idx: torch.Tensor     # (m, n_cap) | (q, m, n_cap) int32
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


def bucket_ladder(n_cap: int, n_max: int) -> Tuple[int, ...]:
    """The ESTIMATE width ladder (shared with the pool's placement)."""
    return _bucket_widths(n_cap, sampling.bucket_cap(min(n_max, n_cap)))


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


def make_lane_params(offsets, scale, keys, epsilons, deltas,
                     sample_keys=None, est_fids=None, *, n_cap: int,
                     device=None) -> LaneParams:
    """Per-lane query parameters (slot tables + seed bases).

    ``keys (q, 2)`` are the lanes' bootstrap keys; ``sample_keys`` ``None``
    derives one slot->row binding per lane from ``keys``, a ``(2,)`` key
    shares ONE binding across lanes, ``(q, 2)`` pins one per lane.
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
    return LaneParams(
        scale=torch.as_tensor(_host(scale, np.float32), device=dev),
        epsilons=torch.as_tensor(_host(epsilons, np.float32), device=dev),
        deltas=torch.as_tensor(_host(deltas, np.float32), device=dev),
        est_fids=torch.as_tensor(_host(est_fids, np.int32), device=dev),
        boot_base=boot, slot_idx=slot_idx,
        group_sizes=torch.as_tensor(
            np.broadcast_to(sizes.astype(np.int32), (q, sizes.shape[0])).copy(),
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
                 growth_cap: float, max_iters: int):
    """FIT + PREDICT for every lane: ``(n_pred (q, m), beta (q, m+1), r2
    (q,), failed_fit (q,))``."""
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
    return n_next, fit.beta, fit.r2, failed


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


def _step_body(values: torch.Tensor, s: LaneState, p: LaneParams, *,
               est_name: Optional[str], B: int, n_min: int, n_max: int,
               l: int, tau: float, max_iters: int, n_cap: int, metric: str,
               growth_cap: float, ext_cap: int, adaptive: bool,
               use_kernel: bool, gate_gather: bool) -> LaneState:
    """One SAMPLE -> ESTIMATE -> FIT -> PREDICT -> TEST tick over all lanes.

    Reads two things on the host, in one transfer: the ESTIMATE bucket index
    and the active-lane mask (which lanes gather).
    """
    est = get_estimator(est_name) if est_name is not None else None
    q, m = s.n_cur.shape
    dev = s.k.device
    # Deterministic balanced two-point design (Eq. 15/16).
    l_min = min(max(int(round(l * n_max / (n_min + n_max))), 1), l - 1)
    widths = bucket_ladder(n_cap, n_max) if adaptive else (n_cap,)

    active = lane_active(s, max_iters)                         # (q,)
    act2 = active[:, None]
    phase = (s.k[:, None] + torch.arange(m, device=dev)[None, :]) % l
    n_init = torch.where(phase < l_min, n_min, n_max).to(torch.int32)
    n_pred, beta, r2, failed_fit = _fit_predict(
        s, p, tau=tau, growth_cap=growth_cap, max_iters=max_iters)
    init_phase = s.k < l                                       # (q,)
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
    # ---- the tick's one host read: bucket index + active lanes ----
    needed = torch.clamp(torch.amax(torch.where(act2, win_hi, 0)), min=1)
    w_arr = torch.as_tensor(widths[:-1], dtype=torch.int32, device=dev)
    b_idx = torch.sum(needed > w_arr).to(torch.int64).reshape(1)
    host = torch.cat([b_idx, active.to(torch.int64)]).cpu().numpy()
    width = widths[int(host[0])]
    gather_lanes = (np.nonzero(host[1:])[0] if gate_gather
                    else np.arange(q))
    # ---- extend the carried nested samples by the window only ----
    _gather_windows(values, s.buf, s.filled, win_hi, p.slot_idx,
                    torch.as_tensor(gather_lanes, dtype=torch.int64,
                                    device=dev), ext_cap)
    filled = torch.maximum(s.filled, win_hi)
    # ---- bootstrap estimate on the active width bucket ----
    seeds = _bootstrap_seeds(p, s.k, m)
    bw = s.buf[:, :, :width]
    pos = torch.arange(width, dtype=torch.int32, device=dev)[None, None, :]
    msk = ((pos >= win_lo[:, :, None]) &
           (pos < win_hi[:, :, None])).to(torch.float32)
    if est is None:
        e_b, theta_b = bootstrap.estimate_error_lanes_het(
            bw, msk, seeds, p.est_fids, p.scale, p.deltas, B=B,
            metric=metric, use_kernel=use_kernel, lane_active=active)
    else:
        e_b, theta_b = bootstrap.estimate_error_lanes(
            est, bw, msk, seeds, p.scale, p.deltas, B=B, metric=metric,
            use_kernel=use_kernel, lane_active=active)
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


def fused_step(values: torch.Tensor, offsets, state: LaneState,
               params: LaneParams, *, est_name: Optional[str] = None,
               B: int = 500, n_min: int = 100, n_max: int = 200, l: int = 10,
               tau: float = 1e-3, max_iters: int = 32, n_cap: int = 1 << 16,
               metric: str = "l2", growth_cap: float = 8.0,
               ext_cap: Optional[int] = None, adaptive: bool = True,
               use_kernel: "bool | str" = "auto", gate_gather: bool = True,
               num_ticks: int = 1) -> LaneState:
    """Host-callable resumable step: ``num_ticks`` ticks over all lanes.

    Converged/failed/exhausted lanes freeze (predicated updates), so ticking
    past a lane's convergence is harmless.  ``est_name=None`` selects each
    lane's estimator from ``params.est_fids``.  ``offsets`` is the group
    layout the params were built for.  The state's ``buf`` is updated in
    place.
    """
    if len(offsets) - 1 != state.n_cur.shape[1]:
        raise ValueError("offsets do not match the state's group count")
    spec = dict(
        est_name=est_name, B=B, n_min=n_min, n_max=n_max, l=l, tau=tau,
        max_iters=max_iters, n_cap=n_cap, metric=metric,
        growth_cap=growth_cap, ext_cap=resolve_ext_cap(n_cap, n_max, ext_cap),
        adaptive=adaptive, use_kernel=resolve_use_kernel(use_kernel, values.device),
        gate_gather=gate_gather)
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
                       deltas, sample_keys=None, est_fids=None, *,
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
    with the same keys: the width bucket is compute width only."""
    dev = values.device
    m = len(offsets) - 1
    params = make_lane_params(offsets, scale, keys, epsilons, deltas,
                              sample_keys, est_fids, n_cap=n_cap, device=dev)
    p_dim = (get_estimator(est_name).out_dim(values.shape[1])
             if est_name is not None else 1)
    state = init_lane_state(keys, m, n_cap=n_cap, c_dim=values.shape[1],
                            p_dim=p_dim, n_min=n_min, max_iters=max_iters,
                            device=dev, dtype=values.dtype)
    spec = dict(
        est_name=est_name, B=B, n_min=n_min, n_max=n_max, l=l, tau=tau,
        max_iters=max_iters, n_cap=n_cap, metric=metric,
        growth_cap=growth_cap, ext_cap=resolve_ext_cap(n_cap, n_max, ext_cap),
        adaptive=adaptive, use_kernel=resolve_use_kernel(use_kernel, values.device),
        gate_gather=gate_gather)
    while bool(lane_active(state, max_iters).any()):
        state = _step_body(values, state, params, **spec)
    return lanes_result(state)


def fused_l2miss(values: torch.Tensor, offsets, scale, key, epsilon, delta,
                 sample_key=None, **static_kwargs) -> FusedResult:
    """Single-query entry point: the q = 1 lane configuration."""
    res = fused_l2miss_lanes(
        values, offsets, _host(scale, np.float32)[None],
        _host(key, np.uint32)[None],
        _host(epsilon, np.float32).reshape(1),
        _host(delta, np.float32).reshape(1), sample_key, **static_kwargs)
    return FusedResult(*(x[0] for x in res))


def fused_l2miss_batch(values_batch: torch.Tensor, offsets, scale_batch, keys,
                       epsilons, delta, sample_keys=None, **static_kwargs
                       ) -> FusedResult:
    """Batch entry point over SHARED-OPERAND lanes: one resident ``(N, c)``
    table; ``scale_batch (q, m)``, ``keys (q, 2)``, ``epsilons (q,)``,
    ``delta`` (scalar or ``(q,)``) and ``sample_keys`` carry the lane axis.
    The reference's legacy ``(q, N, c)`` per-lane tables are not ported."""
    if values_batch.dim() != 2:
        raise NotImplementedError(
            "per-lane (q, N, c) tables are not ported; pass one (N, c) table")
    epsilons = _host(epsilons, np.float32)
    q = epsilons.shape[0]
    deltas = np.broadcast_to(_host(delta, np.float32), (q,))
    return fused_l2miss_lanes(values_batch, offsets, scale_batch, keys,
                              epsilons, deltas, sample_keys, **static_kwargs)
