#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs a CUDA
card and exits non-zero without one.  Phases, in order; any failure exits
non-zero and nothing falls back to the CPU:

1. card and build: print the card's name and power limit, build the kernel
   libraries from ``src/repro_torch/csrc`` with nvcc, one process per source,
   all started together;
2. Poisson-bootstrap kernel against its plain PyTorch version on the card at
   the serve phase's tier shape (4 lanes x 4 groups, B = 300) on every rung
   of the width ladder: rtol 1e-5 (bit-exact expected: same summation
   order), gated == ungated and narrow == wide bucket bit-exact; kernel and
   plain times from CUDA events against the kernel's operation bound;
3. segment-bootstrap kernel at the grouped serve phase's block (9 lanes of
   lineitem SF10 GROUP BY TAX, B = 300) on packed streams of live windows at
   every ``seg_ladder`` rung: against its plain version (rtol 1e-5, bit-exact
   expected) and against the Poisson-bootstrap kernel on the same windows
   (bit-exact: same order); a masked-out (gated) lane adds nothing; kernel
   times against the operation bound, the plain version's at L = 8192;
4. exact segment-aggregate kernel over the whole 60 M-row table GROUP BY
   TAX: against its plain version (bit-exact expected) and numpy float64
   (sums rtol 1e-4, min/max exact); kernel, plain and library (index_add_
   of the five powers plus two scatter_reduce_) times against the byte
   bound;
5. the card against the CPU at the CPU tests' size: ``fused_l2miss``, a small
   ``LanePool`` and ``fused_grouped`` with the same seeds; integer
   trajectories exact, theta rtol 1e-5, error rtol 1e-4, beta norm-wise rtol
   1e-4; a pool lane equal to its solo run and a pool block equal to
   ``fused_grouped`` bit for bit on the card;
6. solo serve at real size: TPC-H ``lineitem`` at scale factor 10 (60 M rows
   of f32 EXTENDEDPRICE resident on the card, GROUP BY SHIPINSTRUCT: 4
   groups), an ``AQPSession`` with the reference defaults (B=300, n_min=1000,
   n_max=2000, max_iters=24, n_cap=65536, forced POOL with 8 lanes in 2
   tiers) answers 16 avg/sum/var/std requests, then one singleton on the
   LOOP route; every request must succeed, 14 of 16 must lie within epsilon
   of the exact answer, and the Poisson-bootstrap kernel must have launched;
7. grouped serve at real size: ``lineitem`` SF10 GROUP BY TAX (9 groups), one
   session as in phase 6 answers 8 GROUP BY requests (avg/sum at epsilon 1 %
   and 2 %, var at 3 % and 4 %, std at 1.5 % and 2 % of the smallest exact
   per-group answer) and the 4 solo requests of phase 6's first wave, in the
   same pool; every grouped request succeeds with every group's error within
   epsilon, 64 of the 72 per-group answers lie within epsilon of numpy's
   exact answer, every solo request succeeds, and both bootstrap kernels
   launched;
8. the segment-bootstrap kernel checked and timed once more, with its plain
   version, at the stream length phase 7 launched most; then the result
   lines: a JSON object of kernel measurements, then
   ``{"ok": true, "device": {...}}`` as the last line.

Phases 6 and 7 are the main paths: every kernel's launch count is set to 0
just before each and read just after; the launches of phases 2-5 and 8
(the comparisons with the plain versions) count nowhere.
"""
import collections
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

B = 300
N_CAP = 1 << 16
N_MAX = 2000
SERVE = dict(B=B, n_min=1000, n_max=N_MAX, max_iters=24, n_cap=N_CAP, seed=0)
OPS_PER_PAIR = 30       # integer ops per (slot, replicate): hash + ladder
INT32_LANES_PER_SM = 64
H100_SMS = 132
HBM_BYTES_PER_S = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _counters():
    from repro_torch.kernels.poisson_bootstrap import ops as pb_ops
    from repro_torch.kernels.segment_agg import ops as seg_ops
    return {"poisson_bootstrap": pb_ops.counter,
            "segment_bootstrap": seg_ops.boot_counter,
            "segment_aggregate": seg_ops.agg_counter}


def reset_counts() -> None:
    """Every kernel's launch count to 0, just before a main path runs."""
    for c in _counters().values():
        c.reset()


def read_counts() -> dict:
    """Every kernel's launches since :func:`reset_counts`."""
    return {k: c.launches for k, c in _counters().items()}


def add_counts(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def cuda_ms(fn, reps: int, rounds: int) -> float:
    """Median over ``rounds`` of the mean CUDA-event time of ``reps``
    back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def phase_kernel(data, clock_hz: float):
    from repro_torch.core import keys, sampling
    from repro_torch.core.fused import bucket_ladder
    from repro_torch.kernels.poisson_bootstrap import ops, ref

    dev = data.values.device
    q, m = 4, data.num_groups
    rng = np.random.default_rng(11)
    starts, sizes = data.offsets[:-1], np.diff(data.offsets)
    # The tier's carried buffer: each lane's groups filled through its own
    # slot table from the resident table, as the serve phase fills them.
    buf = torch.stack([
        data.values[sampling.counter_slot_table(
            keys.prng_key(100 + lane), starts, sizes, N_CAP,
            device=dev).long(), 0] for lane in range(q)])      # (q, m, N_CAP)
    seeds = torch.as_tensor(rng.integers(0, 2**32, (q, m)), device=dev)
    act = torch.tensor([True, True, False, True], device=dev)[:, None]
    act = act.expand(q, m)
    rows = {}
    max_err = 0.0
    for w in bucket_ladder(N_CAP, N_MAX):
        hi = torch.as_tensor(rng.integers(w // 2, w + 1, (q, m)), device=dev)
        pos = torch.arange(w, device=dev)
        mask = (pos < hi[..., None]).to(torch.float32)
        x = buf[..., :w]                       # strided bucket slice
        got = ops.bootstrap_moments_masked(x, mask, seeds, B, lane_active=act)
        want = ref.bootstrap_moments_masked_ref(x, mask, seeds, B,
                                                lane_active=act)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        check(torch.allclose(got, want, rtol=1e-5, atol=0.0),
              f"kernel != plain at w={w} (max abs err {err})")
        ungated = ops.bootstrap_moments_masked(x, mask, seeds, B)
        check(torch.equal(ungated[act], got[act]), f"gated != ungated at {w}")
        check(not got[~act].any(), f"inactive groups not zero at {w}")
        wide = ops.bootstrap_moments_masked(
            buf, torch.nn.functional.pad(mask, (0, N_CAP - w)), seeds, B,
            lane_active=act)
        check(torch.equal(wide, got), f"narrow != wide bucket at w={w}")
        k_ms = cuda_ms(lambda: ops.bootstrap_moments_masked(
            x, mask, seeds, B, lane_active=act), reps=20, rounds=5)
        p_ms = cuda_ms(lambda: ref.bootstrap_moments_masked_ref(
            x, mask, seeds, B, lane_active=act), reps=1, rounds=3)
        pairs = int((mask * act[..., None]).sum().item()) * B
        ops_ms = pairs * OPS_PER_PAIR / (
            H100_SMS * INT32_LANES_PER_SM * clock_hz) * 1e3
        n_bytes = 2 * q * m * w * 4 + q * m * (8 + 4) + q * m * B * 5 * 4
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        rows[w] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=max(ops_ms, bytes_ms),
                       bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                       pairs=pairs, exact=torch.equal(got, want))
        print(f"  w={w:6d} pairs={pairs:10d} kernel {k_ms:.4f} ms  plain "
              f"{p_ms:.3f} ms  bound {rows[w]['bound_ms']:.4f} ms "
              f"({rows[w]['bound_by']})  bit-exact={rows[w]['exact']}")
    print("  library: no single PyTorch call computes Poisson-bootstrap "
          "moment sums with counter-hash weights; no library yardstick")
    return rows, max_err


# ---------------------------------------------------------------------------
# phase 3: the segment-bootstrap kernel at the grouped block's shape
# ---------------------------------------------------------------------------

def _split(total: int, k: int, cap: int, rng) -> np.ndarray:
    """``k`` window widths, each at most ``cap``, summing to ``total``."""
    w = np.minimum(np.floor(rng.dirichlet(np.ones(k)) * total), cap)
    w = w.astype(np.int64)
    while w.sum() < total:
        i = rng.choice(np.flatnonzero(w < cap))
        w[i] += min(cap - w[i], total - w.sum())
    return w


def phase_segment_boot(data, clock_hz: float):
    """Kernel vs plain and vs the Poisson-bootstrap kernel on packed streams
    of live windows at every seg_ladder rung, plain version timed at one;
    returns the per-rung rows and ``measure(L, plain)``, which checks and
    times one more stream of ``L`` elements (the grouped serve's length)."""
    from repro_torch.core import fused, keys, sampling
    from repro_torch.kernels.poisson_bootstrap import ops as pb_ops
    from repro_torch.kernels.segment_agg import ops, ref

    dev = data.values.device
    q = data.num_groups
    rng = np.random.default_rng(12)
    tables = sampling.stratified_slot_tables(keys.prng_key(77), data.offsets,
                                             N_CAP, device=dev)
    buf = data.values[tables[:, 0].long(), 0]                  # (q, N_CAP)
    seeds = torch.as_tensor(rng.integers(0, 2**32, q), device=dev)
    gated = 4                  # frozen lane: no window while others fit

    def measure(L: int, plain: bool) -> dict:
        live = [g for g in range(q) if g != gated or L > (q - 1) * N_CAP]
        w = np.zeros(q, np.int64)
        w[live] = _split(L, len(live), N_CAP, rng)
        lo = rng.integers(0, N_CAP - w + 1)
        gid = np.repeat(np.arange(q), w)
        slot = np.concatenate([np.arange(a, a + b) for a, b in zip(lo, w)])
        gid_t = torch.as_tensor(gid, device=dev)
        slot_t = torch.as_tensor(slot, dtype=torch.int32, device=dev)
        x = buf[gid_t, slot_t.long()]
        off = torch.as_tensor(np.concatenate([[0], np.cumsum(w)]), device=dev)
        args = (x, torch.ones_like(x), slot_t, seeds[gid_t], off, B,
                int((lo + w).max()))
        got = ops.segment_bootstrap_sorted(*args)
        want = ref.segment_bootstrap_sorted_ref(*args)
        pos = torch.arange(N_CAP, device=dev)
        lo_t, hi_t = (torch.as_tensor(v, device=dev) for v in (lo, lo + w))
        mask = ((pos >= lo_t[:, None]) & (pos < hi_t[:, None])).float()
        pb = pb_ops.bootstrap_moments_masked(buf, mask, seeds, B)[..., :3]
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-5, atol=0.0),
              f"segment kernel != plain at L={L} (max abs err {err})")
        check(torch.equal(got, pb),
              f"segment kernel != Poisson-bootstrap kernel at L={L}")
        if gated not in live:
            check(not got[gated].any(), f"frozen lane not zero at L={L}")
        # A masked-out lane's elements in the stream add nothing.
        mk = torch.ones_like(x)
        mk[gid_t == live[0]] = 0.0
        masked = ops.segment_bootstrap_sorted(x, mk, *args[2:])
        check(not masked[live[0]].any() and torch.equal(
            masked[live[1:]], got[live[1:]]), f"gated lane added at L={L}")
        k_ms = cuda_ms(lambda: ops.segment_bootstrap_sorted(*args),
                       reps=20, rounds=5)
        p_ms = (cuda_ms(lambda: ref.segment_bootstrap_sorted_ref(*args),
                        reps=1, rounds=3) if plain else None)
        pairs = L * B
        ops_ms = pairs * OPS_PER_PAIR / (
            H100_SMS * INT32_LANES_PER_SM * clock_hz) * 1e3
        bytes_ms = (20 * L + 8 * (q + 1) + q * B * 3 * 4) / HBM_BYTES_PER_S * 1e3
        row = dict(ms=k_ms, plain_ms=p_ms, bound_ms=max(ops_ms, bytes_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                   max_abs_err=err, exact=torch.equal(got, want))
        print(f"  L={L:7d} pairs={pairs:11d} kernel {k_ms:.4f} ms  bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})  plain "
              f"{'-' if p_ms is None else f'{p_ms:.3f} ms'}  "
              f"bit-exact={row['exact']} == poisson_bootstrap")
        return row

    seg_cap = fused.grouped_seg_cap(data.offsets, N_CAP)
    rows = {L: measure(L, plain=L == 8192)
            for L in fused.seg_ladder(seg_cap, N_MAX)}
    print("  library: no single PyTorch call computes segment Poisson-bootstrap"
          " moment sums with counter-hash weights; no library yardstick")
    return rows, measure


# ---------------------------------------------------------------------------
# phase 4: the exact segment-aggregate kernel over the whole table
# ---------------------------------------------------------------------------

def phase_segment_agg(data, gid_host: np.ndarray):
    from repro_torch.kernels.segment_agg import ops, ref

    dev = data.values.device
    m, n = data.num_groups, data.values.shape[0]
    # The table in its generated (unsorted) row order: GROUP BY input.
    gid = torch.as_tensor(gid_host, device=dev)
    order = torch.sort(gid, stable=True).indices
    x = torch.empty(n, dtype=torch.float32, device=dev)
    x[order] = data.values[:, 0]
    gen = torch.Generator(device=dev).manual_seed(5)
    mask = (torch.rand(n, generator=gen, device=dev) > 0.05).float()
    gid32 = gid.to(torch.int32)
    got = ops.segment_aggregate(gid32, x, mask, m)
    want = ref.segment_aggregate_ref(gid32, x, mask, m)
    torch.cuda.synchronize()
    max_err = max(float((got[k] - want[k]).abs().max()) for k in want)
    exact_plain = all(torch.equal(got[k], want[k]) for k in want)
    for k in ref.AGG_KEYS:
        check(torch.allclose(got[k], want[k], rtol=1e-5, atol=0.0),
              f"aggregate kernel != plain on {k}")
    for k in ("min", "max"):
        check(torch.equal(got[k], want[k]), f"aggregate kernel != plain on {k}")
    xh, mh = x.cpu().numpy(), mask.cpu().numpy()
    x64, w64 = xh.astype(np.float64), mh.astype(np.float64)
    for p, k in enumerate(ref.AGG_KEYS):
        ex = np.bincount(gid_host, weights=w64 * x64 ** p, minlength=m)
        check(np.allclose(got[k].cpu().numpy(), ex, rtol=1e-4, atol=0.0),
              f"aggregate {k} vs numpy float64")
    xs, ms = data.values[:, 0].cpu().numpy(), mh[order.cpu().numpy()]
    for g in range(m):
        a, b = data.offsets[g], data.offsets[g + 1]
        live = xs[a:b][ms[a:b] > 0]
        check(float(got["min"][g]) == live.min()
              and float(got["max"][g]) == live.max(), f"min/max of group {g}")
    k_ms = cuda_ms(lambda: ops.segment_aggregate(gid32, x, mask, m),
                   reps=10, rounds=5)
    p_ms = cuda_ms(lambda: ref.segment_aggregate_ref(gid32, x, mask, m),
                   reps=1, rounds=3)
    feats = ref.aggregate_features(x, mask)
    lo_in = torch.where(mask > 0, x, ref.BIG)
    hi_in = torch.where(mask > 0, x, -ref.BIG)

    def library():
        out = torch.zeros((m, 5), dtype=torch.float32, device=dev)
        out.index_add_(0, gid, feats)
        torch.full((m,), ref.BIG, device=dev).scatter_reduce_(
            0, gid, lo_in, "amin")
        torch.full((m,), -ref.BIG, device=dev).scatter_reduce_(
            0, gid, hi_in, "amax")

    l_ms = cuda_ms(library, reps=5, rounds=3)
    bound_ms = 12 * n / HBM_BYTES_PER_S * 1e3
    print(f"  n={n} m={m}: kernel {k_ms:.4f} ms  plain {p_ms:.3f} ms  "
          f"library {l_ms:.4f} ms  bound {bound_ms:.4f} ms (bytes)  "
          f"bit-exact={exact_plain}; sums vs numpy float64 rtol 1e-4, "
          f"min/max exact")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=bound_ms,
                max_abs_err=max_err)


# ---------------------------------------------------------------------------
# phase 5: the card against the CPU at the CPU tests' size
# ---------------------------------------------------------------------------

KW = dict(B=100, n_min=300, n_max=600, l=6, max_iters=16, n_cap=1 << 13,
          ext_cap=1 << 10)


def _np(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _same_answer(a, b, what: str) -> None:
    """Integers exact; theta rtol 1e-5, error rtol 1e-4, beta norm-wise
    rtol 1e-4 (f32 normal equations of condition ~1e4)."""
    for f in ("n", "iterations", "success", "failed", "rows_sampled"):
        va, vb = _np(getattr(a, f)), _np(getattr(b, f))
        check(np.array_equal(va, vb), f"{what}: {f} differs {va} vs {vb}")
    check(np.allclose(_np(a.theta), _np(b.theta), rtol=1e-5, atol=0),
          f"{what}: theta")
    ea, eb = float(a.error), float(b.error)
    check(abs(ea - eb) <= 1e-4 * abs(eb), f"{what}: error {ea} vs {eb}")
    ba, bb = _np(a.beta), _np(b.beta)
    check(np.linalg.norm(ba - bb) <= 1e-4 * np.linalg.norm(bb),
          f"{what}: beta {ba} vs {bb}")


def phase_card_vs_cpu():
    from repro_torch.aqp.query import Query
    from repro_torch.core import keys
    from repro_torch.core.fused import fused_l2miss
    from repro_torch.data import make_grouped
    from repro_torch.serve import LanePool

    args = (["normal", "exp"], 60_000)
    kw = dict(seed=1, biases=[5.0, 3.0])
    dc, dh = make_grouped(*args, **kw, device="cuda"), \
        make_grouped(*args, **kw, device="cpu")
    for est, key, eps in (("avg", 3, 0.1), ("var", 3, 0.1), ("std", 4, 0.08)):
        res = [fused_l2miss(d.values, d.offsets, np.ones(2, np.float32),
                            keys.prng_key(key), eps, 0.05,
                            **{**KW, "est_name": est}) for d in (dc, dh)]
        check(bool(res[0].success), f"fused_l2miss {est} did not converge")
        _same_answer(res[0], res[1], f"fused_l2miss {est}")
        print(f"  fused_l2miss {est}: n={res[0].n.tolist()} "
              f"iters={int(res[0].iterations)} card == cpu")
    skey = keys.prng_key(42)
    specs = [("avg", 0.06), ("var", 0.25), ("avg", 0.25), ("std", 0.3)]
    qkeys = keys.split(keys.prng_key(11), len(specs))
    out = []
    for d in (dc, dh):
        pool = LanePool(d, lanes=2, tiers=1, sample_key=skey, seed=5, **KW)
        for (f, e), k in zip(specs, qkeys):
            pool.submit(Query(func=f, epsilon=e), key=k)
        out.append(pool.drain())
    for a, b in zip(*out):
        _same_answer(a, b, f"pool {a.func}")
    for (f, e), k, r in zip(specs, qkeys, out[0]):
        solo = fused_l2miss(dc.values, dc.offsets, np.ones(2, np.float32), k,
                            e, 0.05, sample_key=skey,
                            **{**KW, "est_name": f, "l": pool._spec["l"]})
        check(np.array_equal(r.n, solo.n.cpu().numpy())
              and r.error == float(solo.error)
              and np.array_equal(r.theta, solo.theta.cpu().numpy()),
              f"pool lane != solo run on the card ({f}, {e})")
    print(f"  lane pool: {len(specs)} answers card == cpu; "
          f"pool lane == solo bit-exact on the card")
    phase_card_vs_cpu_grouped()


GSPEC = dict(B=64, n_min=200, n_max=400, max_iters=16, n_cap=1 << 12)
GPOOL = dict(l=6, ext_cap=1 << 9, **GSPEC)


def phase_card_vs_cpu_grouped():
    """``fused_grouped`` card == cpu, and a pool block == ``fused_grouped``
    under the pool's sample key on the card (tests/test_torch_serve_groupby
    's table)."""
    from repro_torch.aqp.query import Query
    from repro_torch.core import keys
    from repro_torch.core.fused import fused_grouped
    from repro_torch.core.sampling import GroupedData
    from repro_torch.serve import LanePool

    G = 8
    rng = np.random.default_rng(7)
    sizes = rng.integers(1200, 6000, size=G)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    vals = np.empty((int(offsets[-1]), 1), np.float32)
    for g in range(G):
        vals[offsets[g]:offsets[g + 1], 0] = rng.normal(
            rng.normal(5.0, 2.0), rng.uniform(0.5, 1.5), size=sizes[g])
    key = keys.prng_key(99)
    for est, eps in (("avg", 0.1), ("std", 0.1)):
        res = [fused_grouped(torch.from_numpy(vals).to(d), offsets,
                             np.ones(G), key, eps, 0.05, est_name=est,
                             **GPOOL) for d in ("cuda", "cpu")]
        for f in ("n", "iterations", "success", "failed", "rows_sampled"):
            check(torch.equal(res[0].__getattribute__(f).cpu(),
                              res[1].__getattribute__(f)),
                  f"fused_grouped {est}: {f} card != cpu")
        check(np.allclose(_np(res[0].theta), _np(res[1].theta), rtol=1e-5,
                          atol=0), f"fused_grouped {est}: theta card != cpu")
        check(np.allclose(_np(res[0].error), _np(res[1].error), rtol=1e-4,
                          atol=0), f"fused_grouped {est}: error card != cpu")
        print(f"  fused_grouped {est}: n={res[0].n.tolist()} card == cpu")
    dc = GroupedData(torch.from_numpy(vals), offsets, device="cuda")
    pool = LanePool(dc, lanes=2, seed=0, sample_key=keys.prng_key(42),
                    **GPOOL)
    pool.submit_group(Query(func="avg", epsilon=0.1, group_by=True), key=key)
    (blk,) = pool.drain()
    ref = fused_grouped(dc.values, offsets, np.ones(G), key, 0.1, 0.05,
                        sample_key=pool._sample_key, est_name=None,
                        est_fids=np.zeros(G, np.int32), **GPOOL)
    check(np.array_equal(blk.n, _np(ref.n))
          and np.array_equal(blk.error, _np(ref.error))
          and np.array_equal(blk.theta, _np(ref.theta[:, 0]))
          and np.array_equal(blk.beta, _np(ref.beta)),
          "pool block != fused_grouped on the card")
    print("  pool block == fused_grouped bit-exact on the card")


# ---------------------------------------------------------------------------
# phase 6: solo serve at real size
# ---------------------------------------------------------------------------

def _exact(values: np.ndarray, offsets: np.ndarray, func: str) -> np.ndarray:
    out = []
    for g in range(len(offsets) - 1):
        x = values[offsets[g]:offsets[g + 1]].astype(np.float64)
        mu = x.mean()
        out.append({"avg": mu, "sum": x.sum(), "var": x.var(),
                    "std": x.std()}[func])
    return np.asarray(out)


def serve_requests(data):
    """The 16 (func, epsilon) requests of the serve phase, epsilon 1-3 % of
    the L2 norm of the func's exact per-group answers, and those answers."""
    host = data.values[:, 0].cpu().numpy()
    fracs = {"avg": (0.01, 0.015, 0.02, 0.025),
             "sum": (0.01, 0.015, 0.02, 0.025),
             "var": (0.015, 0.02, 0.025, 0.03),
             "std": (0.01, 0.015, 0.02, 0.025)}
    exact = {f: _exact(host, data.offsets, f) for f in fracs}
    reqs = [(f, fracs[f][i] * float(np.linalg.norm(exact[f])))
            for i in range(4) for f in ("avg", "sum", "var", "std")]
    return reqs, exact


def phase_serve(data):
    from repro_torch.aqp.query import Query, Request
    from repro_torch.kernels.poisson_bootstrap import ops
    from repro_torch.serve import AQPSession, Planner, Route

    reqs, exact = serve_requests(data)
    widths = collections.Counter()
    launch = ops.bootstrap_moments_masked

    def recording(x, *a, **k):          # host metadata only: no sync
        widths[x.shape[-1]] += 1
        return launch(x, *a, **k)

    sess = AQPSession(data, planner=Planner(mode=Route.POOL, pool_lanes=8),
                      **SERVE)
    check(sess.use_kernel, "the session did not select the CUDA kernel")
    ops.bootstrap_moments_masked = recording
    reset_counts()
    t0 = time.perf_counter()
    for f, e in reqs:
        sess.submit(Request(query=Query(func=f, epsilon=e)))
    res = sess.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pool_counts = read_counts()
    pool_launches = pool_counts["poisson_bootstrap"]
    loop = AQPSession(data, **SERVE)          # auto planner: cold singleton
    reset_counts()
    t1 = time.perf_counter()
    loop.submit(Request(query=Query(func="avg", epsilon=reqs[0][1])))
    (lres,) = loop.drain()
    loop_wall = time.perf_counter() - t1
    loop_counts = read_counts()
    loop_launches = loop_counts["poisson_bootstrap"]
    ops.bootstrap_moments_masked = launch
    check(len(res) == 16, f"{len(res)} of 16 requests answered")
    within = 0
    for r, (f, e) in zip(res, reqs):
        check(r.route is Route.POOL, f"request on route {r.route}")
        check(r.success and r.error <= e,
              f"{f} eps={e:.4g}: success={r.success} error={r.error:.4g}")
        dev = float(np.linalg.norm(r.theta.ravel() - exact[f]))
        within += dev <= e
        print(f"  {f:4s} eps={e:12.4f} error={r.error:12.4f} "
              f"|theta-exact|={dev:12.4f} n={r.n.tolist()} "
              f"latency={r.latency_s * 1e3:8.2f} ms")
    check(within >= 14, f"only {within} of 16 answers within epsilon")
    check(lres.route is Route.LOOP and lres.success
          and lres.error <= reqs[0][1], "LOOP singleton failed")
    check(pool_launches > 0 and loop_launches > 0,
          "the kernel never launched on the main path")
    lat = np.asarray([r.latency_s for r in res]) * 1e3
    st = sess.stats()
    print(f"  serve: wall {wall:.3f} s, latency p50 {np.percentile(lat, 50):.2f}"
          f" ms p99 {np.percentile(lat, 99):.2f} ms, dispatches "
          f"{st['fused_dispatches']}, pool ticks {st['pool']['ticks']}, rows "
          f"touched {st['rows_touched']}, kernel launches {pool_launches}, "
          f"{within}/16 within epsilon")
    print(f"  loop singleton: wall {loop_wall:.3f} s, n={lres.n.tolist()}, "
          f"kernel launches {loop_launches}")
    print(f"  launches by bucket width: {dict(sorted(widths.items()))}")
    return add_counts(pool_counts, loop_counts), widths


# ---------------------------------------------------------------------------
# phase 7: grouped serve at real size
# ---------------------------------------------------------------------------

GROUPED_FRACS = {"avg": (0.01, 0.02), "sum": (0.01, 0.02),
                 "var": (0.03, 0.04), "std": (0.015, 0.02)}


def grouped_requests(data):
    """The grouped serve phase's 12 ``(func, epsilon, group_by)`` requests
    in submit order -- 8 GROUP BY requests at fractions of the smallest
    exact per-group answer, a solo request of phase 6's first wave after
    every second one -- and the exact per-group answers of both kinds."""
    host = data.values[:, 0].cpu().numpy()
    exact = {f: _exact(host, data.offsets, f) for f in GROUPED_FRACS}
    grouped = [(f, frac * float(np.abs(exact[f]).min()))
               for f, fr in GROUPED_FRACS.items() for frac in fr]
    solo, solo_exact = serve_requests(data)
    reqs = []
    for i, (f, e) in enumerate(grouped):
        reqs.append((f, e, True))
        if i % 2:
            reqs.append(solo[i // 2] + (False,))
    return reqs, exact, solo_exact


def phase_grouped_serve(data):
    """8 GROUP BY requests and 4 solo requests in one pool on lineitem SF10
    GROUP BY TAX; returns every kernel's launches in that run and the
    packed-stream lengths the segment kernel ran at."""
    from repro_torch.aqp.query import Query, Request
    from repro_torch.kernels.segment_agg import ops as seg_ops
    from repro_torch.serve import AQPSession, Planner, Route

    reqs, exact, solo_exact = grouped_requests(data)
    grouped = [r[:2] for r in reqs if r[2]]
    solo = [r[:2] for r in reqs if not r[2]]
    lengths = collections.Counter()
    launch = seg_ops.segment_bootstrap_sorted

    def recording(x, *a, **k):          # host metadata only: no sync
        lengths[x.shape[0]] += 1
        return launch(x, *a, **k)

    sess = AQPSession(data, planner=Planner(mode=Route.POOL, pool_lanes=8),
                      **SERVE)
    seg_ops.segment_bootstrap_sorted = recording
    reset_counts()
    t0 = time.perf_counter()
    for f, e, g in reqs:
        sess.submit(Request(query=Query(func=f, epsilon=e, group_by=g)))
    res = sess.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    seg_launches = counts["segment_bootstrap"]
    pb_launches = counts["poisson_bootstrap"]
    seg_ops.segment_bootstrap_sorted = launch
    check(len(res) == 12, f"{len(res)} of 12 requests answered")
    gres = [r for r in res if r.group_by]
    sres = [r for r in res if not r.group_by]
    within = 0
    for r, (f, e) in zip(gres, grouped):
        check(r.route is Route.POOL, f"grouped request on route {r.route}")
        check(r.success and bool((r.group_error <= e).all()),
              f"grouped {f} eps={e:.4g}: success={r.success} "
              f"errors={r.group_error}")
        dev = np.abs(np.asarray(r.theta, np.float64) - exact[f])
        within += int((dev <= e).sum())
        print(f"  GROUP BY {f:4s} eps={e:14.4f} max error="
              f"{float(np.max(r.group_error)):14.4f} max |theta-exact|="
              f"{dev.max():14.4f} n={np.asarray(r.n).tolist()} "
              f"latency={r.latency_s * 1e3:8.2f} ms")
    check(within >= 64, f"only {within} of 72 per-group answers within "
                        f"epsilon")
    for r, (f, e) in zip(sres, solo):
        check(r.route is Route.POOL and r.success and r.error <= e,
              f"solo {f} eps={e:.4g}: success={r.success} error={r.error}")
        dev = float(np.linalg.norm(r.theta.ravel() - solo_exact[f]))
        print(f"  solo {f:4s} eps={e:14.4f} error={r.error:14.4f} "
              f"|theta-exact|={dev:14.4f} n={r.n.tolist()} "
              f"latency={r.latency_s * 1e3:8.2f} ms")
    check(seg_launches > 0 and pb_launches > 0,
          f"a bootstrap kernel never launched on the grouped path "
          f"(segment {seg_launches}, poisson {pb_launches})")
    lat = np.asarray([r.latency_s for r in res]) * 1e3
    st = sess.stats()
    print(f"  grouped serve: wall {wall:.3f} s, latency p50 "
          f"{np.percentile(lat, 50):.2f} ms p99 {np.percentile(lat, 99):.2f}"
          f" ms, dispatches {st['fused_dispatches']}, pool ticks "
          f"{st['pool']['ticks']}, block ticks {st['pool']['block_ticks']}, "
          f"rows touched {st['rows_touched']}, {within}/72 per-group answers"
          f" within epsilon; launches: segment {seg_launches}, "
          f"poisson_bootstrap {pb_launches}")
    print(f"  segment launches by stream length: "
          f"{dict(sorted(lengths.items()))}")
    return counts, lengths


def _lineitem(group_by: str):
    from repro_torch.data import make_lineitem

    t = time.perf_counter()
    data, gid = make_lineitem(scale_factor=10, group_by=group_by,
                              device="cuda")
    torch.cuda.synchronize()
    print(f"lineitem SF10 GROUP BY {group_by}: {data.values.shape[0]} rows, "
          f"groups {np.diff(data.offsets).tolist()}, built in "
          f"{time.perf_counter() - t:.1f} s")
    return data, gid


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: a CUDA card is required")
    from repro_torch.kernels.poisson_bootstrap import ops as pb_ops
    from repro_torch.kernels.segment_agg import ops as seg_ops

    t_start = time.perf_counter()
    # -- phase 1 --
    card = nvidia_smi("name,power.limit")
    print(card)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}; max SM clock {clock_mhz:.0f} MHz")
    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as ex:
        list(ex.map(lambda b: b(verbose=True), (pb_ops.build, seg_ops.build)))
    pb_ops.library()
    seg_ops.library()
    print(f"phase 1: both kernel libraries built in "
          f"{time.perf_counter() - t:.1f} s")
    data, _ = _lineitem("shipinstruct")
    tax, tax_gid = _lineitem("tax")
    # -- phase 2 --
    print("phase 2: Poisson-bootstrap kernel vs plain on the card "
          "(tier 4x4, B=300)")
    pb_rows, pb_err = phase_kernel(data, clock_mhz * 1e6)
    # -- phase 3 --
    print("phase 3: segment-bootstrap kernel vs plain on the card "
          "(9-lane block, B=300)")
    seg_rows, seg_measure = phase_segment_boot(tax, clock_mhz * 1e6)
    # -- phase 4 --
    print("phase 4: exact segment-aggregate kernel over lineitem SF10 "
          "GROUP BY TAX")
    agg = phase_segment_agg(tax, tax_gid)
    # -- phase 5 --
    print("phase 5: card vs cpu at the CPU tests' size")
    phase_card_vs_cpu()
    # -- phase 6 --
    print("phase 6: solo serve, lineitem SF10 GROUP BY SHIPINSTRUCT")
    solo_counts, widths = phase_serve(data)
    # -- phase 7 --
    print("phase 7: grouped serve, lineitem SF10 GROUP BY TAX")
    grouped_counts, lengths = phase_grouped_serve(tax)
    launches = add_counts(solo_counts, grouped_counts)
    print(f"  launches on the main paths (phases 6 + 7): {launches}")
    # -- phase 8 --
    w_main = widths.most_common(1)[0][0]
    r = pb_rows[w_main]
    L_main = lengths.most_common(1)[0][0]
    print(f"phase 8: segment bootstrap at the grouped serve's most used "
          f"stream length")
    s = seg_measure(L_main, plain=True)
    seg_err = max(row["max_abs_err"] for row in [s, *seg_rows.values()])
    print(f"  result rows: Poisson bootstrap at the solo serve's most used "
          f"width w={w_main}; segment bootstrap at L={L_main}; aggregate over "
          f"the whole table (no serve-path caller: 0 launches); total "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "poisson_bootstrap", "route": "cuda",
        "source": "src/repro_torch/csrc/poisson_bootstrap.cu",
        "replaces": "src/repro/kernels/poisson_bootstrap/kernel.py:51",
        "launches": launches["poisson_bootstrap"], "max_abs_err": pb_err,
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None}, {
        "name": "segment_bootstrap", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_agg.cu",
        "replaces": "src/repro/kernels/segment_agg/kernel.py:66",
        "launches": launches["segment_bootstrap"], "max_abs_err": seg_err,
        "ms": s["ms"],
        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
        "bound_by": s["bound_by"], "library_ms": None}, {
        "name": "segment_aggregate", "route": "cuda",
        "source": "src/repro_torch/csrc/segment_agg.cu",
        "replaces": "src/repro/kernels/segment_agg/kernel.py:37",
        "launches": launches["segment_aggregate"],
        "max_abs_err": agg["max_abs_err"],
        "ms": agg["ms"], "plain_ms": agg["plain_ms"],
        "bound_ms": agg["bound_ms"], "bound_by": "bytes",
        "library_ms": agg["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
